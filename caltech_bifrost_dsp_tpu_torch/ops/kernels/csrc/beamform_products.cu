// Fused unpack + beamform + power/VLBI products on the bf16 tensor cores
// of sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/
// beamform_fused.py::beamform_products_pallas (itself a split-bf16 kernel
// for the TPU's matrix unit).
//
// What it computes: the beams b[beam, t] = sum_i g[beam, i] * x[t, i] (no
// conjugation) of one gulp, never written to device memory, and from them
// the ntime_sum power integration (XX, YY, Re XY*, Im XY*) and the beam-0
// X/Y VLBI voltages, in the layouts of ops/beamform.py:
// power [nbeam/2, ntime/ntime_sum, nchan, 4], vlbi [ntime, nchan, 2, 2].
//
// Arithmetic: mma.sync.m16n8k16 (bf16 x bf16 -> fp32).  Per channel the
// complex product is one real product A [64, 2 ninput] x B [2 ninput, tt]
// with A = [Gr | -Gi ; Gi | Gr] (rows 0..31 the real parts of the beams,
// rows 32..63 the imaginary parts) and B = [xr ; xi], the contraction
// index interleaved (k = 2 i: re, k = 2 i + 1: im) so that one 32-bit
// fragment register is one input: (xr, xi) of one byte on the B side,
// (Gr, -Gi) or (Gi, Gr) on the A side.  The 4-bit voltages (-8..7) are
// exact in bf16.  A float32 gain is split EXPLICITLY into three bf16
// terms, hi = bf16(g), mid = bf16(g - hi), lo = bf16(g - hi - mid), whose
// sum is g exactly (8 + 8 + 8 significand bits) for every finite g whose
// low bits do not fall below the float32 denormal range and whose hi does
// not round up to infinity (|g| from about 1e-30 to 3e38; delays_to_gains
// gives |g| of order 1).  Every bf16 x small-integer product is exact in
// fp32, so the result differs from an fp32 FMA loop only in the order and
// rounding of the fp32 sums; with integer gains (wholly in hi) every
// partial sum is an integer below 2^24 and the voltages are bit-exact.
// No TF32 and no implicit conversion anywhere.
//
// A prepass of this file (gain_split_kernel) writes the three terms of
// every gain as words (lo half Gr, hi half Gi) in the order the main
// kernel stages them, [chan][chunk][term][beam 32][KC]; the real rows'
// fragments are that word with the sign of the hi half flipped, the
// imaginary rows' the word with its halves swapped, so one staged tile
// serves both.  It runs on every call (52 MB written at the production
// shape, a few percent of the kernel), so no cached operand can go stale
// when the gains change.
//
// Tile: one block = one channel x tt <= 192 time samples (a multiple of
// ntime_sum), all 64 rows; 8 warps = 2 (real, imaginary rows) x 4 (48
// samples each), 2 x 6 MMA tiles a warp (48 fp32 accumulators a lane) x 3
// terms.  K runs over chunks of KC = 32 inputs: the gain words of the next
// chunk come with cp.async, the packed bytes of the next chunk are
// fetched 16 to a thread into registers before the MMAs of this chunk and
// unpacked to (bf16 re, bf16 im) words after them (four instructions a
// byte: the unpack shares the instruction slots with the MMAs), both into
// the other of two buffers (83 KB of shared memory, two blocks an SM).
// Tiles are [row][KC + 4] words: the 32 lanes of a fragment load (row g,
// word t) fall on banks 4 g + t, all distinct.  After the input loop the
// accumulators go to shared memory once for the integration.
//
// Bound: 8 nchan ntime nbeam ninput flop (8.3e10 at 192 channels, 2400
// spectra, 32 beams, 704 inputs) is 0.084 ms at the 989 TFLOP/s bf16
// rate, less than the 0.10 ms to read the 324 MB block once; the three
// terms make the tensor-core work 0.25 ms.  One shared-memory fragment
// load feeds one MMA, which with the per-chunk fetch, unpack and barrier is
// what paces the loop.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXBEAM = 32;               // single-pol beams
constexpr int TT_MAX = 192;               // time samples per block
constexpr int KC = 32;                    // inputs per staged chunk
constexpr int PITCH = KC + 4;             // words per tile row
constexpr int NSPLIT = 3;                 // bf16 terms of a gain
constexpr int WN = 4;                     // warps along time
constexpr int NT = TT_MAX / WN / 8;       // n8 tiles per warp
constexpr int A_WORDS = NSPLIT * MAXBEAM * PITCH;
constexpr int B_WORDS = TT_MAX * PITCH;
constexpr int VP = TT_MAX + 8;            // beam row pitch, floats
constexpr int NFETCH = (TT_MAX * (KC / 16) + THREADS - 1) / THREADS;
constexpr int SMEM_WORDS = 2 * (A_WORDS + B_WORDS);
static_assert(SMEM_WORDS >= 2 * MAXBEAM * VP, "beams alias the tiles");
static_assert(KC % 16 == 0 && TT_MAX % (8 * WN) == 0, "tile shape");

// The tensor-core instruction and the asynchronous copies sit behind these
// functions; a host build (CBD_HOST_EMULATION, with a cuda_runtime.h that
// supplies them lane by lane) compiles the rest of this file as C++.
#ifdef CBD_HOST_EMULATION
using cbd_emu::cp_async16;
using cbd_emu::cp_async_commit;
using cbd_emu::cp_async_wait_all;
using cbd_emu::mma_m16n8k16_bf16;
using cbd_emu::sub_bf16x2;
#else
// a - b in both bf16 halves of a word
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b)
{
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 pairs along k in a register;
// lane (g = lane / 4, t = lane % 4): a = rows g, g + 8 x k 2t, 2t + 1,
// then the same rows x k 2t + 8, 2t + 9; b = k 2t.., 2t + 8.. x column g;
// c = row g x columns 2t, 2t + 1, then row g + 8
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2])
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* shared, const void* global)
{
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(shared));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
#endif

__host__ __device__ __forceinline__ uint32_t float_bits(float v)
{
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
}

__host__ __device__ __forceinline__ float bits_float(uint32_t u)
{
    float v;
    memcpy(&v, &u, 4);
    return v;
}

// bf16(v), round to nearest even, as the high half of a float's bits
// (what cvt.rn.bf16.f32 gives for finite v; NaN stays NaN)
__host__ __device__ __forceinline__ uint32_t bf16_bits(float v)
{
    uint32_t u = float_bits(v);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) {
        return (u >> 16) | 0x40u;
    }
    u += 0x7FFFu + ((u >> 16) & 1u);
    return u >> 16;
}

// The three bf16 terms of g, each as 16 bits.
__host__ __device__ __forceinline__ void split3(float g, uint32_t (&s)[3])
{
    s[0] = bf16_bits(g);
    const float r1 = g - bits_float(s[0] << 16);
    s[1] = bf16_bits(r1);
    const float r2 = r1 - bits_float(s[1] << 16);
    s[2] = bf16_bits(r2);
}

// Four 4+4-bit bytes as four words (bf16 re) | (bf16 im) << 16.  A nibble
// XORed with 8 is n + 8 in 0..15, and 0x4300 | (n + 8) is the bf16 of
// 128 + (n + 8), exact; one bf16x2 subtraction of 136 from both halves
// leaves (re, im), exact again.  A zero byte gives the zero word.
__device__ __forceinline__ void unpack4(uint32_t raw, uint32_t (&o)[4])
{
    const uint32_t w = raw ^ 0x88888888u;
    const uint32_t re8 = (w >> 4) & 0x0F0F0F0Fu;
    const uint32_t im8 = w & 0x0F0F0F0Fu;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        // bytes 0 and 2 of p: byte u of re8 and of im8
        const uint32_t p = __byte_perm(re8, im8, 0x0400u + 0x0101u * u);
        o[u] = sub_bf16x2((p & 0x00FF00FFu) | 0x43004300u, 0x43084308u);
    }
}

__host__ __device__ __forceinline__ int split_chunks(int ninput)
{
    return (ninput + KC - 1) / KC;
}

// Prepass: gsplit[c][chunk][term][beam][k] = (term of Gr) | (term of Gi)
// << 16 for input chunk * KC + k; zero for beams past nbeam and inputs
// past ninput.
__global__ void __launch_bounds__(THREADS)
gain_split_kernel(const float* __restrict__ g_re,
                  const float* __restrict__ g_im, int nchan, int nbeam,
                  int ninput, uint32_t* __restrict__ gsplit)
{
    const int nchunk = split_chunks(ninput);
    const long long total = static_cast<long long>(nchan) * nchunk
                            * MAXBEAM * KC;
    const long long e = static_cast<long long>(blockIdx.x) * THREADS
                        + threadIdx.x;
    if (e >= total) return;
    const int k = static_cast<int>(e % KC);
    const int b = static_cast<int>(e / KC % MAXBEAM);
    const long long cc = e / (KC * MAXBEAM);            // c * nchunk + chunk
    const int chunk = static_cast<int>(cc % nchunk);
    const int c = static_cast<int>(cc / nchunk);
    const int in = chunk * KC + k;
    float gr = 0.f, gi = 0.f;
    if (b < nbeam && in < ninput) {
        const long long o = (static_cast<long long>(c) * nbeam + b) * ninput
                            + in;
        gr = g_re[o];
        gi = g_im[o];
    }
    uint32_t sr[3], si[3];
    split3(gr, sr);
    split3(gi, si);
    uint32_t* dst = gsplit + cc * (NSPLIT * MAXBEAM * KC) + b * KC + k;
#pragma unroll
    for (int s = 0; s < NSPLIT; ++s) {
        dst[s * MAXBEAM * KC] = sr[s] | (si[s] << 16);
    }
}

__global__ void __launch_bounds__(THREADS, 2)
beamform_products_kernel(const uint8_t* __restrict__ packed,
                         long long stride_c, long long stride_t, int nchan,
                         int ntime, int ninput,
                         const uint32_t* __restrict__ gsplit, int nbeam,
                         int ntime_sum, int tt, int aligned,
                         float* __restrict__ power, float* __restrict__ vlbi)
{
    // two buffers of gain words [term][beam][PITCH] and of voltage words
    // [time][PITCH]; after the input loop reused as v_sh: float
    // [2 (re, im)][MAXBEAM][VP] beams
    extern __shared__ __align__(16) uint32_t tiles[];
    uint32_t* a_sh = tiles;
    uint32_t* b_sh = tiles + 2 * A_WORDS;

    const int c = blockIdx.y;
    const int t0 = blockIdx.x * tt;
    const int nt = min(tt, ntime - t0);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wm = (tid >> 5) & 1;      // 0: real rows, 1: imaginary rows
    const int wn = tid >> 6;            // time columns wn * 48 ..
    const int nmt = nbeam > 16 ? 2 : 1; // m16 tiles with a live beam
    const int nchunk = split_chunks(ninput);

    float acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[m][n][e] = 0.f;
            }
        }
    }

    const uint8_t* base = packed + static_cast<long long>(c) * stride_c
                          + static_cast<long long>(t0) * stride_t;
    const uint32_t* gsrc = gsplit + static_cast<long long>(c) * nchunk
                                    * (NSPLIT * MAXBEAM * KC);

    auto stage_gains = [&](int chunk, uint32_t* buf) {
        constexpr int NV = KC / 4;
        const uint32_t* src = gsrc + static_cast<long long>(chunk)
                                     * (NSPLIT * MAXBEAM * KC);
        for (int item = tid; item < NSPLIT * MAXBEAM * NV; item += THREADS) {
            const int row = item / NV;
            const int v = item - row * NV;
            cp_async16(buf + row * PITCH + 4 * v, src + item * 4);
        }
        cp_async_commit();
    };
    // item = (time sample, 16-input group): 16 packed bytes in four words,
    // zero past the tile's samples and past ninput (a zero byte unpacks to
    // the zero word)
    uint32_t raw[NFETCH][4];
    auto fetch = [&](int chunk) {
#pragma unroll
        for (int it = 0; it < NFETCH; ++it) {
            const int item = it * THREADS + tid;
            const int ts = item / (KC / 16);
            const int k0 = chunk * KC + (item % (KC / 16)) * 16;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                raw[it][q] = 0u;
            }
            if (item >= TT_MAX * (KC / 16) || ts >= nt || k0 >= ninput) {
                continue;
            }
            const uint8_t* src = base + static_cast<long long>(ts) * stride_t
                                 + k0;
            if (aligned && k0 + 16 <= ninput) {
                const int4 v = *reinterpret_cast<const int4*>(src);
                raw[it][0] = static_cast<uint32_t>(v.x);
                raw[it][1] = static_cast<uint32_t>(v.y);
                raw[it][2] = static_cast<uint32_t>(v.z);
                raw[it][3] = static_cast<uint32_t>(v.w);
            } else {
                for (int u = 0; u < 16 && k0 + u < ninput; ++u) {
                    raw[it][u >> 2] |= static_cast<uint32_t>(src[u])
                                       << (8 * (u & 3));
                }
            }
        }
    };
    auto store = [&](uint32_t* buf) {
#pragma unroll
        for (int it = 0; it < NFETCH; ++it) {
            const int item = it * THREADS + tid;
            if (item >= TT_MAX * (KC / 16)) {
                continue;
            }
            uint32_t* dst = buf + (item / (KC / 16)) * PITCH
                            + (item % (KC / 16)) * 16;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                uint32_t o[4];
                unpack4(raw[it][q], o);
                *reinterpret_cast<int4*>(dst + 4 * q) = int4{
                    static_cast<int>(o[0]), static_cast<int>(o[1]),
                    static_cast<int>(o[2]), static_cast<int>(o[3])};
            }
        }
    };

    stage_gains(0, a_sh);
    fetch(0);
    store(b_sh);
    cp_async_wait_all();
    __syncthreads();
    for (int chunk = 0; chunk < nchunk; ++chunk) {
        const uint32_t* a_cur = a_sh + (chunk & 1) * A_WORDS;
        const uint32_t* b_cur = b_sh + (chunk & 1) * B_WORDS;
        const bool more = chunk + 1 < nchunk;
        if (more) {
            stage_gains(chunk + 1, a_sh + ((chunk + 1) & 1) * A_WORDS);
            fetch(chunk + 1);
        }
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
            uint32_t bfr[NT][2];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const uint32_t* p = b_cur + (wn * (NT * 8) + n * 8 + g)
                                            * PITCH + ks * 8 + t;
                bfr[n][0] = p[0];
                bfr[n][1] = p[4];
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                if (m >= nmt) {
                    continue;
                }
#pragma unroll
                for (int s = 0; s < NSPLIT; ++s) {
                    const uint32_t* p = a_cur + (s * MAXBEAM + m * 16 + g)
                                                * PITCH + ks * 8 + t;
                    const uint32_t w[4] = {p[0], p[8 * PITCH], p[4],
                                           p[8 * PITCH + 4]};
                    uint32_t afr[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        // (Gr, -Gi) for the real rows, (Gi, Gr) for the
                        // imaginary rows
                        afr[q] = wm ? (w[q] >> 16) | (w[q] << 16)
                                    : w[q] ^ 0x80000000u;
                    }
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        if (wn * (NT * 8) + n * 8 < nt) {
                            mma_m16n8k16_bf16(acc[m][n], afr, bfr[n]);
                        }
                    }
                }
            }
        }
        if (more) {
            store(b_sh + ((chunk + 1) & 1) * B_WORDS);
        }
        cp_async_wait_all();
        // the next chunk's tiles are complete for every thread, and every
        // thread is done with this chunk's, which the chunk after overwrites
        __syncthreads();
    }

    float* v_sh = reinterpret_cast<float*>(tiles);
    const int im_ofs = MAXBEAM * VP;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = wn * (NT * 8) + n * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float* dst = v_sh + wm * im_ofs + (m * 16 + g + 8 * h) * VP
                             + col;
                dst[0] = acc[m][n][2 * h];
                dst[1] = acc[m][n][2 * h + 1];
            }
        }
    }
    __syncthreads();

    if (vlbi != nullptr) {
        // beam-0 dual-pol voltages: q = beam * 2 + (re, im)
        for (int e = tid; e < nt * 4; e += THREADS) {
            const int ts = e >> 2;
            const int q = e & 3;
            const int beam = q >> 1;
            const int ri = q & 1;
            vlbi[(static_cast<long long>(t0 + ts) * nchan + c) * 4 + q] =
                v_sh[ri * im_ofs + beam * VP + ts];
        }
    }

    if (power != nullptr) {
        const int nbp = nbeam / 2;
        const int ntb = nt / ntime_sum;
        const int ntb_total = ntime / ntime_sum;
        const int tb0 = t0 / ntime_sum;
        for (int e = tid; e < nbp * ntb * 4; e += THREADS) {
            const int comp = e & 3;
            const int r = e >> 2;
            const int tb = r % ntb;
            const int b = r / ntb;
            const int ofs = tb * ntime_sum;
            const float* pxr = v_sh + (2 * b) * VP + ofs;
            const float* pxi = v_sh + im_ofs + (2 * b) * VP + ofs;
            const float* pyr = v_sh + (2 * b + 1) * VP + ofs;
            const float* pyi = v_sh + im_ofs + (2 * b + 1) * VP + ofs;
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
// ninput], contiguous.  gsplit: scratch of at least nchan *
// ceil(ninput / 32) * 3 * 32 * 32 32-bit words (split_words says how
// many), 16-byte aligned.  power / vlbi may be null to skip that product.
// Returns cudaGetLastError() after the launches.
extern "C" int cbd_beamform_products(const void* packed, long long stride_c,
                                     long long stride_t, int nchan,
                                     int ntime, int ninput, const void* g_re,
                                     const void* g_im, int nbeam,
                                     int ntime_sum, void* gsplit,
                                     long long split_words, void* power,
                                     void* vlbi, void* stream)
{
    if (nchan <= 0 || ntime <= 0 || ninput <= 0 || ntime_sum <= 0
        || ntime_sum > TT_MAX || nbeam <= 0 || nbeam % 2 != 0
        || nbeam > MAXBEAM || ntime % ntime_sum != 0 || nchan > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long need = static_cast<long long>(nchan)
                           * split_chunks(ninput) * NSPLIT * MAXBEAM * KC;
    if (split_words < need || reinterpret_cast<uintptr_t>(gsplit) % 16 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const long long nsplit_thread = need / NSPLIT;
    const dim3 grid0(static_cast<unsigned>(
        (nsplit_thread + THREADS - 1) / THREADS));
    gain_split_kernel<<<grid0, THREADS, 0, s>>>(
        static_cast<const float*>(g_re), static_cast<const float*>(g_im),
        nchan, nbeam, ninput, static_cast<uint32_t*>(gsplit));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const size_t smem = SMEM_WORDS * sizeof(uint32_t);
    err = cudaFuncSetAttribute(
        beamform_products_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int tt = (TT_MAX / ntime_sum) * ntime_sum;
    // every 16-byte group of a time sample's inputs is aligned
    const int aligned = reinterpret_cast<uintptr_t>(packed) % 16 == 0
        && stride_c % 16 == 0 && stride_t % 16 == 0;
    const dim3 grid((ntime + tt - 1) / tt, nchan);
    beamform_products_kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, nchan,
        ntime, ninput, static_cast<const uint32_t*>(gsplit), nbeam,
        ntime_sum, tt, aligned, static_cast<float*>(power),
        static_cast<float*>(vlbi));
    return static_cast<int>(cudaGetLastError());
}
