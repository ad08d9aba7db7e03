// Fused PFB channelizer + 4-bit requantizer, for sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py::
// pfb_quantize_packed_pallas, both branches: the direct DFT (pallas_call
// at :434) and the two-stage factored DFT (pallas_call at :383).  It
// computes what that function computes, not its tiles.  For each
// (input i, spectrum s) row:
//
//     fir[n]  = sum_{k < ntap} adc[(s + k) * L + n, i] * window[k, n]
//     X[c]    = sum_n fir[n] (cos - i sin)(2 pi n c / L),   c < nchan
//     out[i, s, c] = (q(Re X[c] * scale[c]) & 0xF) << 4 | (q(Im ...) & 0xF)
//     q(v)    = clamp(rint(v), -8, 7)      (ties to even, as jnp.round)
//
// with L = 2 * nchan.  ADC is [ntime, ninput], int8 or float32, read with
// its own strides (no transpose is materialised); int8 converts to float
// exactly before any arithmetic, so int8 and float32 ADC with the same
// values give the same bytes.  Output is input-major [ninput, nspec,
// nchan], the TPU function's layout.
//
// Precision.  Direct mode contracts on the FP64 tensor cores: the float32
// FIR rows and the float32 table convert to double exactly, every product
// is exact and the sums are double, as in the float64 reference, so the
// only difference from it is the fold below (a table entry may differ from
// its mirror image by one float32 ulp) and the order of the sums: ~5e-8 of
// a code, and few values land on the other side of a rounding threshold.
// The factored mode runs in float32 FMA (never TF32, which would flip many
// rounding decisions) with float32 partial sums over 32-term slices added
// into a float64 accumulator.  v * scale is formed in float64.  fast=1
// (the TPU kernel's bf16 mode, pfb_fused.py:95-102) rounds the DFT operands
// to bf16 with __float2bfloat16_rn where the TPU kernel casts: the FIR
// frames, the tables (rounded by the wrapper) and, in the factored
// transform, the twiddled intermediates (:269-276); direct mode then runs
// the same FP64 contraction on the rounded operands, which is what the
// reference of that mode computes.
//
// Direct mode (L < 2048; production L = 384), mma.sync.m16n8k8.f64.  The
// real-input DFT is folded: with e[n] = fir[n] + fir[L - n] and o[n] =
// fir[n] - fir[L - n] for 0 < n < nchan (e[0] = fir[0], e[nchan] =
// fir[nchan]), Re X[c] = sum_{n <= nchan} e[n] cos(2 pi n c / L) and
// Im X[c] = -sum_{0 < n < nchan} o[n] sin(2 pi n c / L): two products of
// depth nchan + 1 instead of one of depth 2 nchan, half the operations
// (2.5e11 flop per 2400-spectra window at 704 inputs: 3.7 ms at the 67
// TFLOP/s FP64 tensor peak, which m16n8k8 reaches to 95% on this card and
// m8n8k4 to half).  A block owns 16 inputs x 3 spectra = 48 rows (16 x 1
// where 48 rows of a long L do not fit).  Their e and o go to shared memory
// as doubles, the contraction index outer with a row pitch of 52 (20)
// doubles so that the 16 lanes of a half-warp fragment load fall on
// distinct 8-byte banks, and never to device memory.  The table [pass]
// [k / 8][cos, -sin][8][192] (float32, 307 KB at nchan = 192, resident in
// L2) is streamed with cp.async through a ring of four 12.8 KB slabs, row
// pitch 200 floats (banks 8 t + g); its fragments convert to double at
// load and are reused over the block's three row tiles.  Each of 8 warps owns all rows x
// 24 channels (3 x 3 MMA tiles for Re and for Im, 144 accumulator
// registers), so Re and Im of a channel meet in one lane for the nibble
// pack.  Bound: the FP64 tensor rate.  The FIR comes on top: one block
// fills an SM, so its FIR phase and its MMA loop do not overlap; int8
// frames are first copied into the idle slab ring in one cp.async wave,
// because a thread's own byte loads would wait on memory latency for
// longer than the MMAs take.
//
// Factored mode (L >= 2048 with (L1, L2) from ops/pfb.py::_dft_factors;
// F-engine L = 8192 -> (128, 64)).  One row's frame is strided by ninput
// in the ADC, so a first kernel computes FIR rows for 32-input tiles with
// coalesced reads and writes them contiguous per row to a float32 scratch
// (the wrapper bounds it to 1 GB by running the spectra in chunks).  The
// second kernel takes one row per block: frame (L floats) and the
// twiddled [L1, L2] complex intermediate live in dynamic shared memory
// (96 KB at L = 8192, above the 48 KB static limit, hence
// cudaFuncSetAttribute); stage 1 is the inner DFT over n2 (8 x 8 register
// tiles), then the complex twiddle, then stage 2 the outer DFT over n1
// for k1 < L1/2 (4 x 4 complex register tiles); bin k = k1 * L2 + k2 is
// written in place, so the TPU kernel's reorder outside (:415-416) has no
// counterpart.  Bound: fp32 FMA, 3.2e6 FMA per row, plus the scratch
// round trip (8 L bytes per row).

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// direct mode tiling
constexpr int D_TI = 16;              // inputs per block: one m16 row tile
constexpr int D_MT = 3;               // spectra (row tiles) per block
constexpr int D_NT = 3;               // n8 tiles per warp and table
constexpr int D_CPASS = (THREADS / 32) * D_NT * 8;  // channels per pass
constexpr int D_KS = 8;               // table rows per slab: one MMA k step
constexpr int D_BP = D_CPASS + 8;     // slab row pitch, floats
constexpr int D_SLAB = 2 * D_KS * D_BP;             // floats per slab
constexpr int D_NSTAGE = 4;           // slabs in flight (cp.async ring)
constexpr int MAX_SHARED = 232448;    // bytes one block may use

// factored mode: FIR tile of the first kernel
constexpr int F_TI = 32;
constexpr int F_TN = 32;
constexpr int F_SLICE = 32;           // n1 slice of the float64 accumulation

__device__ __forceinline__ float bf16r(float v)
{
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float madd(float a, float b, float c)
{
    return fmaf(a, b, c);
}

__device__ __forceinline__ double madd(double a, double b, double c)
{
    return fma(a, b, c);
}

__device__ __forceinline__ int quant(double v)
{
    return static_cast<int>(fmin(fmax(rint(v), -8.0), 7.0));
}

__device__ __forceinline__ uint32_t pack_nibbles(double re, double im)
{
    return static_cast<uint32_t>(((quant(re) & 0xF) << 4) | (quant(im) & 0xF));
}

// FIR of sample n of the spectrum whose first frame starts at t0, input i,
// summed in float64 (each product is exact there) and rounded once to
// float32, and to bf16 when FAST: the rounding of an operand is then the
// rounding of the exact FIR, which the float64 reference reproduces.
template <typename T, bool FAST>
__device__ __forceinline__ float fir_sample(const T* __restrict__ adc,
                                            long long st_t, long long st_i,
                                            const float* __restrict__ w,
                                            int ntap, int L, long long t0,
                                            int n, int i)
{
    double acc = 0.0;
    for (int k = 0; k < ntap; ++k) {
        const double x = static_cast<double>(
            adc[(t0 + static_cast<long long>(k) * L + n) * st_t
                + static_cast<long long>(i) * st_i]);
        acc = madd(x, static_cast<double>(w[k * L + n]), acc);
    }
    const float v = static_cast<float>(acc);
    return FAST ? bf16r(v) : v;
}

// fir_sample of samples n and m for the MT consecutive spectra of a block,
// input column i of ``frames`` (the block's first frame; ``nframe`` frames
// exist, later ones read as zero).  The MT + ntap - 1 frames are loaded
// once for both samples, all loads started before the first sum and no
// branch taken, so that the 2 MT sums are independent chains; each runs
// over k ascending in float64 as in fir_sample, so the values are the same
// bit for bit.
constexpr int D_MAXTAP = 8;

template <typename T, bool FAST, int MT>
__device__ __forceinline__ void fir_rows(const T* __restrict__ frames,
                                         long long st_t, long long st_i,
                                         const float* __restrict__ w,
                                         int ntap, int L, int nframe, int n,
                                         int m, int i, float (&a)[MT],
                                         float (&b)[MT])
{
    if (ntap > D_MAXTAP) {
#pragma unroll
        for (int si = 0; si < MT; ++si) {
            const bool row = si + ntap <= nframe;
            const long long t0 = static_cast<long long>(si) * L;
            a[si] = row ? fir_sample<T, FAST>(frames, st_t, st_i, w, ntap, L,
                                              t0, n, i) : 0.f;
            b[si] = row ? fir_sample<T, FAST>(frames, st_t, st_i, w, ntap, L,
                                              t0, m, i) : 0.f;
        }
        return;
    }
    double xn[MT + D_MAXTAP - 1], xm[MT + D_MAXTAP - 1];
    double wn[D_MAXTAP], wm[D_MAXTAP];
    const T* col = frames + static_cast<long long>(i) * st_i;
#pragma unroll
    for (int f = 0; f < MT + D_MAXTAP - 1; ++f) {
        const bool have = f < MT + ntap - 1 && f < nframe;
        const long long t = static_cast<long long>(have ? f : 0) * L;
        const T vn = col[(t + n) * st_t];
        const T vm = col[(t + m) * st_t];
        xn[f] = have ? static_cast<double>(vn) : 0.0;
        xm[f] = have ? static_cast<double>(vm) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < D_MAXTAP; ++k) {
        const int kk = k < ntap ? k : 0;
        wn[k] = static_cast<double>(w[kk * L + n]);
        wm[k] = static_cast<double>(w[kk * L + m]);
    }
#pragma unroll
    for (int si = 0; si < MT; ++si) {
        double sn = 0.0, sm = 0.0;
#pragma unroll
        for (int k = 0; k < D_MAXTAP; ++k) {
            if (k < ntap) {
                sn = madd(xn[si + k], wn[k], sn);
                sm = madd(xm[si + k], wm[k], sm);
            }
        }
        const float rn = static_cast<float>(sn), rm = static_cast<float>(sm);
        a[si] = FAST ? bf16r(rn) : rn;
        b[si] = FAST ? bf16r(rm) : rm;
    }
}

// The FP64 tensor-core instruction and the asynchronous copies sit behind
// these functions; a host build (CBD_HOST_EMULATION, with a cuda_runtime.h
// that supplies them lane by lane) compiles the rest of this file as C++.
#ifdef CBD_HOST_EMULATION
using cbd_emu::cp_async16;
using cbd_emu::cp_async_commit;
using cbd_emu::cp_async_wait_but;
using cbd_emu::mma_m16n8k8_f64;
#else
// c[16 x 8] += a[16 x 8] b[8 x 8]; lane (g = lane / 4, t = lane % 4):
// a = rows g, g + 8 x k t, then k t + 4; b = k t, t + 4 x column g;
// c = row g x columns 2t, 2t + 1, then row g + 8
__device__ __forceinline__ void mma_m16n8k8_f64(double (&c)[4],
                                                const double (&a)[4],
                                                const double (&b)[2])
{
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
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

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_but()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
#endif

// Bytes of dynamic shared memory of the direct kernel with MT row tiles:
// e and o [kpad][16 MT + 4] doubles, and the ring of table slabs.
__host__ __device__ constexpr size_t direct_smem(int kpad, int mt)
{
    return static_cast<size_t>(2) * kpad * (16 * mt + 4) * sizeof(double)
        + D_NSTAGE * D_SLAB * sizeof(float);
}

// MT row tiles: rows r = si * 16 + ii for spectrum s0 + si, input i0 + ii.
template <typename T, bool FAST, int MT>
__global__ void __launch_bounds__(THREADS, 1)
pfb_direct_kernel(const T* __restrict__ adc, long long st_t, long long st_i,
                  int ninput, int nspec, int nchan, int ntap,
                  const float* __restrict__ window,
                  const float* __restrict__ table, int kpad, int npad,
                  const float* __restrict__ scale, int tile_adc,
                  uint8_t* __restrict__ out)
{
    extern __shared__ float4 smem4[];
    constexpr int AP = 16 * MT + 4;       // pitch: banks (4 t + g) mod 16
    double* es = reinterpret_cast<double*>(smem4);    // e[kpad][AP]
    double* os = es + kpad * AP;                      // o[kpad][AP]
    float* slabs = reinterpret_cast<float*>(os + kpad * AP);
    const int L = 2 * nchan;
    const int tid = threadIdx.x;
    // input tile fastest: the blocks that run together read the same ADC
    // rows (704 contiguous bytes at the production width, 16 a block)
    const int ntile_i = (ninput + D_TI - 1) / D_TI;
    const int s0 = static_cast<int>(blockIdx.x / ntile_i) * MT;
    const int i0 = static_cast<int>(blockIdx.x % ntile_i) * D_TI;

    // The block's frames.  Read straight from device memory, a thread has
    // a dozen byte loads in flight and the FIR waits on memory latency for
    // longer than the MMAs take; so where the ADC is int8 with 16-byte rows
    // per block (``tile_adc``), all frames are first copied, 16 inputs x
    // one sample to a cp.async, into the slab ring, which is idle until
    // the MMA loop.
    const int nframe = min(MT + ntap - 1, nspec + ntap - 1 - s0);
    const T* frames = adc + static_cast<long long>(s0) * L * st_t;
    bool tiled = false;
    if constexpr (sizeof(T) == 1) {
        tiled = tile_adc && static_cast<size_t>(MT + ntap - 1) * L * D_TI
                                <= D_NSTAGE * D_SLAB * sizeof(float);
        if (tiled) {
            int8_t* tile = reinterpret_cast<int8_t*>(slabs);
            for (int item = tid; item < nframe * L; item += THREADS) {
                cp_async16(tile + item * D_TI,
                           frames + static_cast<long long>(item) * st_t + i0);
            }
            cp_async_commit();
            cp_async_wait_but<0>();
            __syncthreads();
        }
    }

    // folded FIR rows for n <= nchan; zero past the edges (frames past the
    // last read as zero, so spectra past nspec come out zero) and in the
    // pad rows of e and o.  Inputs past ninput read the last input's
    // column and are zeroed.
    {
        const int ii = tid % D_TI;
        const bool live = i0 + ii < ninput;
        const T* src = tiled ? reinterpret_cast<const T*>(slabs) : frames;
        const long long src_t = tiled ? D_TI : st_t;
        const long long src_i = tiled ? 1 : st_i;
        const int col = tiled ? ii : min(i0 + ii, ninput - 1);
#pragma unroll 2
        for (int n = tid / D_TI; n <= nchan; n += THREADS / D_TI) {
            const bool pair = n > 0 && n < nchan;
            float a[MT], b[MT];
            fir_rows<T, FAST, MT>(src, src_t, src_i, window, ntap, L, nframe,
                                  n, pair ? L - n : n, col, a, b);
#pragma unroll
            for (int si = 0; si < MT; ++si) {
                const bool row = live && si + ntap <= nframe;
                const double x = row ? a[si] : 0.f;
                const double y = row && pair ? b[si] : 0.f;
                es[n * AP + si * D_TI + ii] = x + y;
                os[n * AP + si * D_TI + ii] = pair ? x - y : 0.0;
            }
        }
        for (int n = nchan + 1 + tid / D_TI; n < kpad;
             n += THREADS / D_TI) {
#pragma unroll
            for (int si = 0; si < MT; ++si) {
                es[n * AP + si * D_TI + ii] = 0.0;
                os[n * AP + si * D_TI + ii] = 0.0;
            }
        }
    }
    __syncthreads();    // the tile is consumed before the ring takes slabs

    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    const int nslab = kpad / D_KS;
    // one slab = [cos, -sin][D_KS] rows of D_CPASS floats, contiguous;
    // a copy group is committed for every slab index, empty past the last,
    // so that the count of groups in flight tells which slab has landed
    auto stage = [&](int pass, int slab) {
        constexpr int NV = D_CPASS / 4;
        if (slab < nslab) {
            float* buf = slabs + (slab % D_NSTAGE) * D_SLAB;
            const float* src = table
                + static_cast<long long>(pass * nslab + slab)
                  * (2 * D_KS * D_CPASS);
            for (int item = tid; item < 2 * D_KS * NV; item += THREADS) {
                const int row = item / NV;
                const int v = item - row * NV;
                cp_async16(buf + row * D_BP + 4 * v,
                           src + row * D_CPASS + 4 * v);
            }
        }
        cp_async_commit();
    };

    for (int pass = 0; pass < npad / D_CPASS; ++pass) {
        double re[MT][D_NT][4], im[MT][D_NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int n = 0; n < D_NT; ++n) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    re[m][n][q] = 0.0;
                    im[m][n][q] = 0.0;
                }
            }
        }
#pragma unroll
        for (int slab = 0; slab < D_NSTAGE - 1; ++slab) {
            stage(pass, slab);
        }
        for (int slab = 0; slab < nslab; ++slab) {
            const float* cur = slabs + (slab % D_NSTAGE) * D_SLAB;
            cp_async_wait_but<D_NSTAGE - 2>();
            // slab ``slab`` (and, the first time, e and o) is complete for
            // every thread, and every thread is done with slab - 1, whose
            // buffer the next copy overwrites
            __syncthreads();
            stage(pass, slab + D_NSTAGE - 1);
            double bc[D_NT][2], bs[D_NT][2];
#pragma unroll
            for (int n = 0; n < D_NT; ++n) {
                const int col = (warp * D_NT + n) * 8 + g;
                bc[n][0] = cur[t * D_BP + col];
                bc[n][1] = cur[(t + 4) * D_BP + col];
                bs[n][0] = cur[(D_KS + t) * D_BP + col];
                bs[n][1] = cur[(D_KS + t + 4) * D_BP + col];
            }
            const double* e0 = es + (slab * D_KS + t) * AP + g;
            const double* o0 = os + (slab * D_KS + t) * AP + g;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                const double ae[4] = {e0[m * 16], e0[m * 16 + 8],
                                      e0[4 * AP + m * 16],
                                      e0[4 * AP + m * 16 + 8]};
                const double ao[4] = {o0[m * 16], o0[m * 16 + 8],
                                      o0[4 * AP + m * 16],
                                      o0[4 * AP + m * 16 + 8]};
#pragma unroll
                for (int n = 0; n < D_NT; ++n) {
                    mma_m16n8k8_f64(re[m][n], ae, bc[n]);
                    mma_m16n8k8_f64(im[m][n], ao, bs[n]);
                }
            }
        }
        // requantize and pack: Re and Im of a channel sit in the same lane
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            const int s = s0 + m;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int i = i0 + g + (q >> 1) * 8;
                if (i >= ninput || s >= nspec) {
                    continue;
                }
                uint8_t* row = out + (static_cast<long long>(i) * nspec + s)
                                     * nchan;
#pragma unroll
                for (int n = 0; n < D_NT; ++n) {
                    const int c = pass * D_CPASS + (warp * D_NT + n) * 8
                                  + 2 * t + (q & 1);
                    if (c < nchan) {
                        const double sc = scale[c];
                        row[c] = static_cast<uint8_t>(pack_nibbles(
                            re[m][n][q] * sc, im[m][n][q] * sc));
                    }
                }
            }
        }
        __syncthreads();   // the last slab is consumed before the next pass
    }
}

// Factored mode, kernel 1: FIR rows of spectra [s_first, s_first + nsc)
// into scratch[i][s - s_first][n] (float32, bf16-rounded when FAST).
template <typename T, bool FAST>
__global__ void __launch_bounds__(THREADS)
pfb_fir_rows_kernel(const T* __restrict__ adc, long long st_t,
                    long long st_i, int ninput, int s_first, int L, int ntap,
                    const float* __restrict__ window,
                    float* __restrict__ scratch, int chunk)
{
    __shared__ float tile[F_TN][F_TI + 1];
    const int n0 = blockIdx.x * F_TN;
    const int sl = blockIdx.y;
    const long long t0 = static_cast<long long>(s_first + sl) * L;
    const int i0 = blockIdx.z * F_TI;
    {
        const int ii = threadIdx.x % F_TI;
        for (int nn = threadIdx.x / F_TI; nn < F_TN;
             nn += THREADS / F_TI) {
            float v = 0.f;
            if (i0 + ii < ninput) {
                v = fir_sample<T, FAST>(adc, st_t, st_i, window, ntap, L, t0,
                                        n0 + nn, i0 + ii);
            }
            tile[nn][ii] = v;
        }
    }
    __syncthreads();
    const int nn = threadIdx.x % F_TN;
    for (int ii = threadIdx.x / F_TN; ii < F_TI; ii += THREADS / F_TN) {
        const int i = i0 + ii;
        if (i < ninput) {
            scratch[(static_cast<long long>(i) * chunk + sl) * L + n0 + nn] =
                tile[nn][ii];
        }
    }
}

// Factored mode, kernel 2: one (input, spectrum) row per block.
//   inner [L2][2 L2]: (c2, s2) of (n2, k2) interleaved
//   tw    [L1][L2][2]: (twr, twi)
//   outer [L1][L1/2][2]: (c1, s1)
template <bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
pfb_factored_kernel(const float* __restrict__ scratch, int chunk,
                    int s_first, int nspec, int nchan, int L1, int L2,
                    const float* __restrict__ inner,
                    const float* __restrict__ tw,
                    const float* __restrict__ outer,
                    const float* __restrict__ scale,
                    uint8_t* __restrict__ out)
{
    extern __shared__ float4 smem4[];
    const int L = L1 * L2;
    float* fir = reinterpret_cast<float*>(smem4);   // fir[n1 + L1 * n2]
    float* tws = fir + L;                           // [n1][k2][re, im]
    const int sl = blockIdx.x;
    const int i = blockIdx.y;
    const int s = s_first + sl;

    const float4* src = reinterpret_cast<const float4*>(
        scratch + (static_cast<long long>(i) * chunk + sl) * L);
    for (int q = threadIdx.x; q < L / 4; q += THREADS) {
        smem4[q] = src[q];
    }
    __syncthreads();

    // stage 1: S[n1][k2] = sum_n2 fir[n1 + L1 n2] (c2 + i s2)[n2][k2],
    // then T = S * (twr + i twi); tile = TM1 n1 x 4 k2 (8 float columns).
    // FAST sums in float64, so that T is rounded to bf16 from (nearly) the
    // exact value, as in the reference.
    constexpr int TM1 = FAST ? 4 : 8;
    using Acc = typename std::conditional<FAST, double, float>::type;
    const int ncg1 = 2 * L2 / 8;
    for (int t = threadIdx.x; t < (L1 / TM1) * ncg1; t += THREADS) {
        const int cg = t % ncg1;
        const int mg = t / ncg1;
        Acc acc[TM1][8];
#pragma unroll
        for (int m = 0; m < TM1; ++m) {
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                acc[m][n] = Acc(0);
            }
        }
        for (int n2 = 0; n2 < L2; ++n2) {
            const float* ap = fir + n2 * L1 + mg * TM1;
            const float4* bp = reinterpret_cast<const float4*>(
                inner + n2 * 2 * L2 + cg * 8);
            const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
            float a[TM1];
#pragma unroll
            for (int m = 0; m < TM1; m += 4) {
                const float4 a4 = *reinterpret_cast<const float4*>(ap + m);
                a[m] = a4.x;
                a[m + 1] = a4.y;
                a[m + 2] = a4.z;
                a[m + 3] = a4.w;
            }
            const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int m = 0; m < TM1; ++m) {
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    acc[m][n] = madd(Acc(a[m]), Acc(b[n]), acc[m][n]);
                }
            }
        }
#pragma unroll
        for (int m = 0; m < TM1; ++m) {
            const int n1 = mg * TM1 + m;
            float v[8];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k2 = cg * 4 + j;
                const float2 w = __ldg(
                    reinterpret_cast<const float2*>(tw) + n1 * L2 + k2);
                const Acc sr = acc[m][2 * j];
                const Acc si = acc[m][2 * j + 1];
                const Acc tr = sr * Acc(w.x) - si * Acc(w.y);
                const Acc ti = sr * Acc(w.y) + si * Acc(w.x);
                v[2 * j] = FAST ? bf16r(static_cast<float>(tr))
                                : static_cast<float>(tr);
                v[2 * j + 1] = FAST ? bf16r(static_cast<float>(ti))
                                    : static_cast<float>(ti);
            }
            float4* dst = reinterpret_cast<float4*>(
                tws + (n1 * L2 + cg * 4) * 2);
            dst[0] = make_float4(v[0], v[1], v[2], v[3]);
            dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    }
    __syncthreads();

    // stage 2: X[k1][k2] = sum_n1 (c1 - i s1)[n1][k1] T[n1][k2], k1 < L1/2;
    // tile = 4 k1 x 4 k2
    const int h = L1 / 2;
    const int nkg2 = L2 / 4;
    uint8_t* row = out + (static_cast<long long>(i) * nspec + s) * nchan;
    for (int t = threadIdx.x; t < (h / 4) * nkg2; t += THREADS) {
        const int kg2 = t % nkg2;
        const int kg1 = t / nkg2;
        double xr64[4][4], xi64[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                xr64[p][q] = 0.0;
                xi64[p][q] = 0.0;
            }
        }
        for (int b0 = 0; b0 < L1; b0 += F_SLICE) {
            float xr[4][4], xi[4][4];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    xr[p][q] = 0.f;
                    xi[p][q] = 0.f;
                }
            }
            const int b1 = min(b0 + F_SLICE, L1);
            for (int n1 = b0; n1 < b1; ++n1) {
                const float4* op = reinterpret_cast<const float4*>(
                    outer + (n1 * h + kg1 * 4) * 2);
                const float4* tp = reinterpret_cast<const float4*>(
                    tws + (n1 * L2 + kg2 * 4) * 2);
                const float4 o0 = __ldg(op), o1 = __ldg(op + 1);
                const float4 t0 = tp[0], t1 = tp[1];
                const float c[4] = {o0.x, o0.z, o1.x, o1.z};
                const float sn[4] = {o0.y, o0.w, o1.y, o1.w};
                const float tr[4] = {t0.x, t0.z, t1.x, t1.z};
                const float ti[4] = {t0.y, t0.w, t1.y, t1.w};
#pragma unroll
                for (int p = 0; p < 4; ++p) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        xr[p][q] = fmaf(c[p], tr[q], xr[p][q]);
                        xr[p][q] = fmaf(sn[p], ti[q], xr[p][q]);
                        xi[p][q] = fmaf(c[p], ti[q], xi[p][q]);
                        xi[p][q] = fmaf(-sn[p], tr[q], xi[p][q]);
                    }
                }
            }
#pragma unroll
            for (int p = 0; p < 4; ++p) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    xr64[p][q] += static_cast<double>(xr[p][q]);
                    xi64[p][q] += static_cast<double>(xi[p][q]);
                }
            }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const int k1 = kg1 * 4 + p;
            uint32_t word = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const double sc = scale[k1 * L2 + kg2 * 4 + q];
                word |= pack_nibbles(xr64[p][q] * sc, xi64[p][q] * sc)
                        << (8 * q);
            }
            *reinterpret_cast<uint32_t*>(row + k1 * L2 + kg2 * 4) = word;
        }
    }
}

template <typename T, bool FAST, int MT>
cudaError_t launch_direct_tiles(const void* adc, long long st_t,
                                long long st_i, int ninput, int nspec,
                                int nchan, int ntap, const void* window,
                                const void* table, int kpad, int npad,
                                const void* scale, void* out,
                                cudaStream_t stream)
{
    const size_t smem = direct_smem(kpad, MT);
    auto kernel = pfb_direct_kernel<T, FAST, MT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        return err;
    }
    // every block's 16 inputs of one sample are 16 aligned bytes
    const int tile_adc = sizeof(T) == 1 && st_i == 1 && st_t % 16 == 0
        && ninput % D_TI == 0 && reinterpret_cast<uintptr_t>(adc) % 16 == 0;
    const long long nblock = static_cast<long long>((nspec + MT - 1) / MT)
                             * ((ninput + D_TI - 1) / D_TI);
    if (nblock > 2147483647LL) {
        return cudaErrorInvalidValue;
    }
    const dim3 grid(static_cast<unsigned>(nblock));
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(adc), st_t, st_i, ninput, nspec, nchan, ntap,
        static_cast<const float*>(window), static_cast<const float*>(table),
        kpad, npad, static_cast<const float*>(scale), tile_adc,
        static_cast<uint8_t*>(out));
    return cudaGetLastError();
}

// Three row tiles a block where their e and o fit shared memory, else one.
template <typename T, bool FAST>
cudaError_t launch_direct(const void* adc, long long st_t, long long st_i,
                          int ninput, int nspec, int nchan, int ntap,
                          const void* window, const void* table, int kpad,
                          int npad, const void* scale, void* out,
                          cudaStream_t stream)
{
    if (direct_smem(kpad, D_MT) <= MAX_SHARED) {
        return launch_direct_tiles<T, FAST, D_MT>(
            adc, st_t, st_i, ninput, nspec, nchan, ntap, window, table, kpad,
            npad, scale, out, stream);
    }
    if (direct_smem(kpad, 1) <= MAX_SHARED) {
        return launch_direct_tiles<T, FAST, 1>(
            adc, st_t, st_i, ninput, nspec, nchan, ntap, window, table, kpad,
            npad, scale, out, stream);
    }
    return cudaErrorInvalidValue;
}

template <typename T, bool FAST>
cudaError_t launch_factored(const void* adc, long long st_t, long long st_i,
                            int ninput, int nspec, int nchan, int ntap,
                            int L1, int L2, const void* window,
                            const void* inner, const void* tw,
                            const void* outer, const void* scale,
                            void* scratch, int chunk, void* out,
                            cudaStream_t stream)
{
    const int L = 2 * nchan;
    const size_t smem = 3 * static_cast<size_t>(L) * sizeof(float);
    auto kernel = pfb_factored_kernel<FAST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        return err;
    }
    for (int s_first = 0; s_first < nspec; s_first += chunk) {
        const int nsc = chunk < nspec - s_first ? chunk : nspec - s_first;
        const dim3 grid1(L / F_TN, nsc, (ninput + F_TI - 1) / F_TI);
        pfb_fir_rows_kernel<T, FAST><<<grid1, THREADS, 0, stream>>>(
            static_cast<const T*>(adc), st_t, st_i, ninput, s_first, L, ntap,
            static_cast<const float*>(window),
            static_cast<float*>(scratch), chunk);
        err = cudaGetLastError();
        if (err != cudaSuccess) {
            return err;
        }
        kernel<<<dim3(nsc, ninput), THREADS, smem, stream>>>(
            static_cast<const float*>(scratch), chunk, s_first, nspec, nchan,
            L1, L2, static_cast<const float*>(inner),
            static_cast<const float*>(tw), static_cast<const float*>(outer),
            static_cast<const float*>(scale), static_cast<uint8_t*>(out));
        err = cudaGetLastError();
        if (err != cudaSuccess) {
            return err;
        }
    }
    return cudaSuccess;
}

}  // namespace

// adc: [ntime, ninput] int8 (is_int8) or float32 with element strides
// st_t, st_i; window f32 [ntap][2 nchan]; table f32 [npad / 192][kpad / 8]
// [cos, -sin][8][192] (see ops/pfb_fused.py::_direct_table), 16-byte
// aligned; scale f32 [nchan]; out uint8 [ninput][nspec][nchan].  Returns
// the CUDA error of the launch.
extern "C" int cbd_pfb_direct(const void* adc, long long st_t,
                              long long st_i, int is_int8, int ninput,
                              int nspec, int nchan, int ntap,
                              const void* window, const void* table,
                              int kpad, int npad, const void* scale,
                              int fast, void* out, void* stream)
{
    if (ninput <= 0 || nspec <= 0 || ntap <= 0 || nchan <= 0
        || kpad < nchan + 1 || kpad % D_KS != 0 || npad < nchan
        || npad % D_CPASS != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (is_int8) {
        err = fast ? launch_direct<int8_t, true>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, window,
                         table, kpad, npad, scale, out, s)
                   : launch_direct<int8_t, false>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, window,
                         table, kpad, npad, scale, out, s);
    } else {
        err = fast ? launch_direct<float, true>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, window,
                         table, kpad, npad, scale, out, s)
                   : launch_direct<float, false>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, window,
                         table, kpad, npad, scale, out, s);
    }
    return static_cast<int>(err);
}

// As cbd_pfb_direct, with L1 * L2 = 2 nchan, the factored tables of
// ops/pfb_fused.py::_factored_tables, and a float32 scratch
// [ninput][chunk][2 nchan] for the FIR rows of up to chunk spectra.
extern "C" int cbd_pfb_factored(const void* adc, long long st_t,
                                long long st_i, int is_int8, int ninput,
                                int nspec, int nchan, int ntap, int L1,
                                int L2, const void* window, const void* inner,
                                const void* tw, const void* outer,
                                const void* scale, int fast, void* scratch,
                                int chunk, void* out, void* stream)
{
    const int L = 2 * nchan;
    if (ninput <= 0 || nspec <= 0 || ntap <= 0 || L1 * L2 != L
        || L1 % 16 != 0 || L2 % 8 != 0 || L % F_TN != 0 || chunk <= 0
        || chunk > 65535 || ninput > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (is_int8) {
        err = fast ? launch_factored<int8_t, true>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, L1, L2,
                         window, inner, tw, outer, scale, scratch, chunk,
                         out, s)
                   : launch_factored<int8_t, false>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, L1, L2,
                         window, inner, tw, outer, scale, scratch, chunk,
                         out, s);
    } else {
        err = fast ? launch_factored<float, true>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, L1, L2,
                         window, inner, tw, outer, scale, scratch, chunk,
                         out, s)
                   : launch_factored<float, false>(
                         adc, st_t, st_i, ninput, nspec, nchan, ntap, L1, L2,
                         window, inner, tw, outer, scale, scratch, chunk,
                         out, s);
    }
    return static_cast<int>(err);
}
