// Host stand-in for <cuda_bf16.h>: round-to-nearest-even conversion of a
// float to bfloat16 and back, on the float's bits.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t bits; };

inline __nv_bfloat16 __float2bfloat16_rn(float v)
{
    uint32_t u;
    std::memcpy(&u, &v, 4);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) {      // NaN stays NaN
        return __nv_bfloat16{static_cast<uint16_t>((u >> 16) | 0x40)};
    }
    u += 0x7FFFu + ((u >> 16) & 1u);
    return __nv_bfloat16{static_cast<uint16_t>(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 h)
{
    const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
    float v;
    std::memcpy(&v, &u, 4);
    return v;
}
