// Fused unpack + beamform + power/VLBI products, for sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/
// beamform_fused.py::beamform_products_pallas.
//
// One block takes one channel and a tile of tt time samples (a multiple of
// ntime_sum, at most 96).  It forms the beams b[beam, t] = sum_i g[beam, i]
// * x[t, i] (no conjugation) with fp32 FMA from fp32 gains, staging KC
// inputs at a time in shared memory, and never writes the voltages to
// device memory.  Thread (bp, lane) holds the X and Y beams (2 bp, 2 bp + 1)
// of one dual-pol beam at times lane + 16 j.  After the input loop the
// voltages go to shared memory, where the ntime_sum power integration
// (XX, YY, Re XY*, Im XY*) runs as a per-thread sum and the beam-0 X/Y
// VLBI voltages are written out, in the layouts of ops/beamform.py:
// power [nbeam/2, ntime/ntime_sum, nchan, 4], vlbi [ntime, nchan, 2, 2].
//
// Bound: about 42 G fp32 FMA per window at 32 beams, 704 inputs,
// 192 channels and 2400 spectra; the packed input (324 MB) is read once.
// Operands come from shared memory as float2 (re, im) pairs, six voltage
// loads and two gain loads per 48 FMA.  A tensor-core formulation
// (3 x bf16 or TF32 splits with an exactness argument) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NLANE = 16;                 // time lanes per beam pair
constexpr int MAXBP = THREADS / NLANE;    // dual-pol beams (32 single-pol)
constexpr int TPL = 6;                    // time samples per lane
constexpr int TT_MAX = NLANE * TPL;       // 96
constexpr int KC = 32;                    // inputs per staged chunk
constexpr int XP = TT_MAX + 1;            // voltage row pitch (float2)
constexpr int GP = KC + 1;                // gain row pitch (float2)

__device__ __forceinline__ int sext4(unsigned v) {
    return static_cast<int>(v ^ 8u) - 8;
}

__global__ void __launch_bounds__(THREADS)
beamform_products_kernel(const uint8_t* __restrict__ packed,
                         long long stride_c, long long stride_t, int nchan,
                         int ntime, int ninput,
                         const float* __restrict__ g_re,
                         const float* __restrict__ g_im, int nbeam,
                         int ntime_sum, int tt, float* __restrict__ power,
                         float* __restrict__ vlbi)
{
    // x_sh: [KC][XP] unpacked (re, im) voltages; after the input loop it
    // is reused as v_sh: float [2 (re, im)][2 * MAXBP][TT_MAX] beams
    __shared__ __align__(16) float2 x_sh[KC * XP];
    __shared__ __align__(16) float2 g_sh[2 * MAXBP * GP];

    const int c = blockIdx.y;
    const int t0 = blockIdx.x * tt;
    const int nt = min(tt, ntime - t0);
    const int nbp = nbeam / 2;
    const int tid = threadIdx.x;
    const int bp = tid / NLANE;
    const int lane = tid % NLANE;

    float xr[TPL], xi[TPL], yr[TPL], yi[TPL];
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
        xr[j] = 0.f;
        xi[j] = 0.f;
        yr[j] = 0.f;
        yi[j] = 0.f;
    }

    const uint8_t* base = packed + static_cast<long long>(c) * stride_c
                          + static_cast<long long>(t0) * stride_t;
    const long long gofs = static_cast<long long>(c) * nbeam * ninput;

    for (int k0 = 0; k0 < ninput; k0 += KC) {
        for (int e = tid; e < 2 * MAXBP * KC; e += THREADS) {
            const int b = e / KC;
            const int k = e % KC;
            float2 g = make_float2(0.f, 0.f);
            if (b < nbeam && k0 + k < ninput) {
                const long long o = gofs + static_cast<long long>(b) * ninput
                                    + k0 + k;
                g = make_float2(g_re[o], g_im[o]);
            }
            g_sh[b * GP + k] = g;
        }
        for (int e = tid; e < TT_MAX * KC; e += THREADS) {
            const int t = e / KC;
            const int k = e % KC;
            float2 x = make_float2(0.f, 0.f);
            if (t < nt && k0 + k < ninput) {
                const unsigned v = base[static_cast<long long>(t) * stride_t
                                        + k0 + k];
                x = make_float2(static_cast<float>(sext4(v >> 4)),
                                static_cast<float>(sext4(v & 15u)));
            }
            x_sh[k * XP + t] = x;
        }
        __syncthreads();
        if (bp < nbp) {
            for (int k = 0; k < KC; ++k) {
                const float2 gx = g_sh[(2 * bp) * GP + k];
                const float2 gy = g_sh[(2 * bp + 1) * GP + k];
#pragma unroll
                for (int j = 0; j < TPL; ++j) {
                    const float2 x = x_sh[k * XP + lane + NLANE * j];
                    xr[j] = fmaf(gx.x, x.x, xr[j]);
                    xr[j] = fmaf(-gx.y, x.y, xr[j]);
                    xi[j] = fmaf(gx.x, x.y, xi[j]);
                    xi[j] = fmaf(gx.y, x.x, xi[j]);
                    yr[j] = fmaf(gy.x, x.x, yr[j]);
                    yr[j] = fmaf(-gy.y, x.y, yr[j]);
                    yi[j] = fmaf(gy.x, x.y, yi[j]);
                    yi[j] = fmaf(gy.y, x.x, yi[j]);
                }
            }
        }
        __syncthreads();
    }

    float* v_sh = reinterpret_cast<float*>(x_sh);
    const int im_ofs = 2 * MAXBP * TT_MAX;
    if (bp < nbp) {
#pragma unroll
        for (int j = 0; j < TPL; ++j) {
            const int t = lane + NLANE * j;
            v_sh[(2 * bp) * TT_MAX + t] = xr[j];
            v_sh[im_ofs + (2 * bp) * TT_MAX + t] = xi[j];
            v_sh[(2 * bp + 1) * TT_MAX + t] = yr[j];
            v_sh[im_ofs + (2 * bp + 1) * TT_MAX + t] = yi[j];
        }
    }
    __syncthreads();

    if (vlbi != nullptr) {
        // beam-0 dual-pol voltages: q = beam * 2 + (re, im)
        for (int e = tid; e < nt * 4; e += THREADS) {
            const int t = e >> 2;
            const int q = e & 3;
            const int beam = q >> 1;
            const int ri = q & 1;
            vlbi[(static_cast<long long>(t0 + t) * nchan + c) * 4 + q] =
                v_sh[ri * im_ofs + beam * TT_MAX + t];
        }
    }

    if (power != nullptr) {
        const int ntb = nt / ntime_sum;
        const int ntb_total = ntime / ntime_sum;
        const int tb0 = t0 / ntime_sum;
        for (int e = tid; e < nbp * ntb * 4; e += THREADS) {
            const int comp = e & 3;
            const int r = e >> 2;
            const int tb = r % ntb;
            const int b = r / ntb;
            const int ofs = tb * ntime_sum;
            const float* pxr = v_sh + (2 * b) * TT_MAX + ofs;
            const float* pxi = v_sh + im_ofs + (2 * b) * TT_MAX + ofs;
            const float* pyr = v_sh + (2 * b + 1) * TT_MAX + ofs;
            const float* pyi = v_sh + im_ofs + (2 * b + 1) * TT_MAX + ofs;
            float s = 0.f;
            for (int u = 0; u < ntime_sum; ++u) {
                const float ar = pxr[u], ai = pxi[u];
                const float br = pyr[u], bi = pyi[u];
                float term;
                if (comp == 0) {
                    term = ar * ar + ai * ai;          // XX
                } else if (comp == 1) {
                    term = br * br + bi * bi;          // YY
                } else if (comp == 2) {
                    term = ar * br + ai * bi;          // Re X conj(Y)
                } else {
                    term = ai * br - ar * bi;          // Im X conj(Y)
                }
                s += term;
            }
            power[((static_cast<long long>(b) * ntb_total + tb0 + tb) * nchan
                   + c) * 4 + comp] = s;
        }
    }
}

}  // namespace

// packed: uint8 chan-major view, element (c, t, i) at
// c * stride_c + t * stride_t + i.  Gains: fp32 planes [nchan, nbeam,
// ninput], contiguous.  power / vlbi may be null to skip that product.
// Returns cudaGetLastError() after the launch.
extern "C" int cbd_beamform_products(const void* packed, long long stride_c,
                                     long long stride_t, int nchan,
                                     int ntime, int ninput, const void* g_re,
                                     const void* g_im, int nbeam,
                                     int ntime_sum, void* power, void* vlbi,
                                     void* stream)
{
    if (ntime_sum <= 0 || ntime_sum > TT_MAX || nbeam % 2 != 0
        || nbeam > 2 * MAXBP || ntime % ntime_sum != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int tt = (TT_MAX / ntime_sum) * ntime_sum;
    const dim3 grid((ntime + tt - 1) / tt, nchan);
    beamform_products_kernel<<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, nchan,
        ntime, ninput, static_cast<const float*>(g_re),
        static_cast<const float*>(g_im), nbeam, ntime_sum, tt,
        static_cast<float*>(power), static_cast<float*>(vlbi));
    return static_cast<int>(cudaGetLastError());
}
