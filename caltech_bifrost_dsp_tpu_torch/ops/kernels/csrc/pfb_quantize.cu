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
// Precision.  Both modes contract on the FP64 tensor cores: the float32
// FIR rows and the float32 tables convert to double exactly, every product
// is exact and the sums are double, as in the float64 reference.  What
// differs from it is the order of the sums and, in direct mode, the fold
// below (a table entry may differ from its mirror image by one float32
// ulp): ~5e-8 of a code; in factored mode, the twiddled intermediate kept
// as float32 between the stages (~1e-7 of a code) and the mirrored half of
// stage 1.  Few values land on the other side of a rounding threshold.
// Never TF32, which would flip many rounding decisions.  v * scale is
// formed in float64.  fast=1 (the TPU kernel's bf16 mode,
// pfb_fused.py:95-102) rounds the DFT operands to bf16 with
// __float2bfloat16_rn where the TPU kernel casts: the FIR frames, the
// tables (rounded by the wrapper) and, in the factored transform, the
// twiddled intermediates (:269-276), rounded from the float64 stage-1 sum;
// the same FP64 contraction then runs on the rounded operands, which is
// what the reference of that mode computes.
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
// Factored mode (L >= 2048 with (L1, L2) from ops/pfb.py::_dft_factors,
// L1 % 16 == 0 and L2 % 8 == 0; F-engine L = 8192 -> (128, 64)),
// mma.sync.m16n8k8.f64 in both DFT stages.  One row's frame is strided by
// ninput in the ADC, so a first kernel computes FIR rows with coalesced
// reads (int8: 16 inputs of a sample to a 16-byte load, a 64 x 64 tile
// transposed through shared memory) and writes them contiguous per row to
// a float32 scratch (the wrapper bounds it to 1 GB by running the spectra
// in chunks).  The scratch stays: a row's intermediate is 64 KB, so a block
// holds one row, not the 16 inputs whose bytes share a 16-byte line of the
// ADC; a block that reads its one input's bytes itself would pull every
// line 16 times through L2 (88 GB a call).  The second kernel takes one row
// per block, two blocks an SM: the row (cp.async) and the twiddled
// [L1, L2] complex intermediate live in dynamic shared memory (106 KB at
// L = 8192); stage 1 is the inner DFT over n2, halved by the real-input
// mirror, then the complex twiddle, then stage 2 the outer DFT over n1 for
// k1 < L1/2; bin k = k1 * L2 + k2 is written in place, so the TPU kernel's
// reorder outside (:415-416) has no counterpart.  Bound: the FP64 tensor
// rate, 5.2e6 flop per row (0.886e12 per 704 x 240 rows: 13.2 ms at 67
// TFLOP/s), plus the scratch round trip (8 L bytes per row).

#include <cstdint>
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

__device__ __forceinline__ float bf16r(float v)
{
    return __bfloat162float(__float2bfloat16_rn(v));
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

// Factored mode, kernel 1 for int8 ADC whose every 16 inputs of a sample
// are 16 aligned bytes: a thread loads the 16 inputs of one sample with one
// 16-byte load per tap (all taps in flight before the first sum) and forms
// their 16 sums, each over k ascending in float64 as fir_sample does, so
// the rows are the same bit for bit; the 64 x 64 tile is transposed
// through shared memory and written 256 contiguous bytes per input.
constexpr int V_TI = 64;
constexpr int V_TN = 64;

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
pfb_fir_rows16_kernel(const int8_t* __restrict__ adc, long long st_t,
                      int ninput, int s_first, int L, int ntap,
                      const float* __restrict__ window,
                      float* __restrict__ scratch, int chunk)
{
    __shared__ float tile[V_TI][V_TN + 1];
    const int n0 = blockIdx.x * V_TN;
    const int sl = blockIdx.y;
    const int i0 = blockIdx.z * V_TI;
    const int nn = threadIdx.x / (V_TI / 16);
    const int iq = threadIdx.x % (V_TI / 16);
    const int ig = i0 + 16 * iq;
    double acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        acc[j] = 0.0;
    }
    if (ig < ninput) {
        const int8_t* p = adc
            + (static_cast<long long>(s_first + sl) * L + n0 + nn) * st_t
            + ig;
        const float* w = window + n0 + nn;
#pragma unroll 4
        for (int k = 0; k < ntap; ++k) {
            const int4 v = *reinterpret_cast<const int4*>(
                p + static_cast<long long>(k) * L * st_t);
            const double wk = static_cast<double>(w[k * L]);
            const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int x = static_cast<int8_t>(
                    static_cast<unsigned>(words[j >> 2]) >> (8 * (j & 3)));
                acc[j] = madd(static_cast<double>(x), wk, acc[j]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const float v = static_cast<float>(acc[j]);
        tile[16 * iq + j][nn] = FAST ? bf16r(v) : v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < V_TI * V_TN; e += THREADS) {
        const int ii = e / V_TN;
        const int n = e % V_TN;
        if (i0 + ii < ninput) {
            scratch[(static_cast<long long>(i0 + ii) * chunk + sl) * L + n0
                    + n] = tile[ii][n];
        }
    }
}

// Factored mode, kernel 2: one (input, spectrum) row per block, both DFT
// stages on mma.sync.m16n8k8.f64.  Tables (float32, converted to double at
// fragment load, as the row's values are):
//   inner [L2 (n2)][L2]: column 2u = c2[n2][u], column 2u + 1 = s2[n2][u]
//     for 0 < u < L2/2; column 0 = c2[n2][0], column 1 = c2[n2][L2/2];
//     FAST: [L2][2 L2], columns 2u, 2u + 1 = (c2, s2)[n2][u] for every u
//   tw    [L1][L2][2]: (twr, twi)
//   outer [2 (c1, s1)][L1 (n1)][L1/2 (k1)]
// Stage 1, S[n1][k2] = sum_n2 fir[n1 + L1 n2] (c2 + i s2)[n2][k2], is the
// product [n1] x [n2] x [columns above]: the input is real, so only
// k2 <= L2/2 is computed and S[n1][L2 - k2] = conj S[n1][k2] (the tables
// are mirror images but for entries that are zero to 1e-13).  FAST
// computes every k2 from the full table instead: there T is rounded to
// bf16, a sum of few-bit products can sit exactly on a rounding tie, and
// the tie is then broken by those 1e-13 entries, which the mirror image
// does not reproduce.  (cos, sin) of one k2 are neighbouring columns, so Re
// and Im of S meet in one lane for the twiddle T = S (twr + i twi), formed
// in double and stored as float32 (bf16-rounded when FAST) planes Tr, Ti
// [n1][L2 + 8].  Stage 2, X[k2][k1] = sum_n1 T[n1][k2] (c1 - i s1)[n1][k1]
// for k1 < L1/2, is four real products with A = T transposed (rows k2)
// and B the outer table, a warp taking 2 x 2 MMA tiles.  Both row pitches
// are 8 mod 32 floats, so the 32 lanes of an A fragment load (k index t,
// row g) fall on banks 8 t + g, all distinct.  The packed row is assembled
// in shared memory (bin k = k1 L2 + k2) and written out in 16-byte pieces.
// Two 8-warp blocks an SM hide each other's barriers, copies and
// epilogues.  Forms that ran slower on an H100 at the F-engine shape
// (this kernel 22.1 ms as it stands): Karatsuba's three products with
// operand sums formed in double; one 16-warp block an SM that walks over
// rows and prefetches the next; T or the tables kept as doubles to save
// the float32 -> float64 conversions at fragment load (the table
// fragments come from L2, and their bytes cost more than the conversions).
constexpr int F_PAD = 8;

__host__ __device__ constexpr size_t factored_smem(int L1, int L2)
{
    return (static_cast<size_t>(L2) * (L1 + F_PAD)
            + static_cast<size_t>(2) * L1 * (L2 + F_PAD)) * sizeof(float);
}

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
    const int P1 = L1 + F_PAD;
    const int P2 = L2 + F_PAD;
    float* fir = reinterpret_cast<float*>(smem4);   // fir[n2][P1], n1 inner
    float* tre = fir + L2 * P1;                     // Tr[n1][P2]
    float* tim = tre + L1 * P2;                     // Ti[n1][P2]
    const int sl = blockIdx.x;
    const int i = blockIdx.y;
    const int s = s_first + sl;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    constexpr int NWARP = THREADS / 32;

    {
        const float* src = scratch
            + (static_cast<long long>(i) * chunk + sl) * L;
        for (int q = tid; q < L / 4; q += THREADS) {
            const int n = 4 * q;
            cp_async16(fir + (n / L1) * P1 + n % L1, src + n);
        }
        cp_async_commit();
        cp_async_wait_but<0>();
        __syncthreads();
    }

    // stage 1: item = (m16 tile of n1, group of up to 8 n8 column tiles)
    const int nmt1 = L1 / 16;
    const int ncol = FAST ? 2 * L2 : L2;
    const int nnt1 = ncol / 8;
    const int ngrp = (nnt1 + 7) / 8;
    for (int item = warp; item < nmt1 * ngrp; item += NWARP) {
        const int mt = item % nmt1;
        const int nt0 = (item / nmt1) * 8;
        double acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc[n][q] = 0.0;
            }
        }
        for (int ks = 0; ks < L2 / 8; ++ks) {
            const float* ap = fir + (8 * ks + t) * P1 + 16 * mt + g;
            const double a[4] = {ap[0], ap[8], ap[4 * P1], ap[4 * P1 + 8]};
            const float* bp = inner + (8 * ks + t) * ncol + g;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                if (nt0 + n < nnt1) {
                    const double b[2] = {
                        __ldg(bp + 8 * (nt0 + n)),
                        __ldg(bp + 4 * ncol + 8 * (nt0 + n))};
                    mma_m16n8k8_f64(acc[n], a, b);
                }
            }
        }
        // twiddle; FAST rounds T to bf16 from the float64 value, as the
        // reference does
        auto emit = [&](int n1, int k2, double sr, double si) {
            const float2 w = __ldg(
                reinterpret_cast<const float2*>(tw) + n1 * L2 + k2);
            const float tr = static_cast<float>(
                sr * static_cast<double>(w.x) - si * static_cast<double>(w.y));
            const float ti = static_cast<float>(
                sr * static_cast<double>(w.y) + si * static_cast<double>(w.x));
            tre[n1 * P2 + k2] = FAST ? bf16r(tr) : tr;
            tim[n1 * P2 + k2] = FAST ? bf16r(ti) : ti;
        };
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            if (nt0 + n >= nnt1) {
                continue;
            }
            const int u = 4 * (nt0 + n) + t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int n1 = 16 * mt + g + 8 * h;
                const double c0 = acc[n][2 * h], c1 = acc[n][2 * h + 1];
                if (FAST) {
                    emit(n1, u, c0, c1);
                } else if (u == 0) {
                    emit(n1, 0, c0, 0.0);
                    emit(n1, L2 / 2, c1, 0.0);
                } else {
                    emit(n1, u, c0, c1);
                    emit(n1, L2 - u, c0, -c1);
                }
            }
        }
    }
    __syncthreads();

    // stage 2: item = (pair of m16 tiles of k2, pair of n8 tiles of k1);
    // rows of a ragged last k2 tile read the pad of Tr, Ti and are not
    // stored.  Im X takes -s1, negated once per table fragment.
    const int h1 = L1 / 2;
    const int nmt2 = (L2 + 15) / 16;
    const int nnt2 = h1 / 8;
    const int nmp2 = (nmt2 + 1) / 2;
    uint8_t* orow = reinterpret_cast<uint8_t*>(fir);   // fir is consumed
    for (int item = warp; item < nmp2 * ((nnt2 + 1) / 2); item += NWARP) {
        const int mt0 = (item % nmp2) * 2;
        const int nt0 = (item / nmp2) * 2;
        double xr[2][2][4], xi[2][2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    xr[m][n][q] = 0.0;
                    xi[m][n][q] = 0.0;
                }
            }
        }
        for (int ks = 0; ks < L1 / 8; ++ks) {
            double ar[2][4], ai[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                // a tile past the last reads the last tile's rows again
                const int mt = mt0 + m < nmt2 ? mt0 + m : mt0;
                const int o = (8 * ks + t) * P2 + 16 * mt + g;
                ar[m][0] = tre[o];
                ar[m][1] = tre[o + 8];
                ar[m][2] = tre[o + 4 * P2];
                ar[m][3] = tre[o + 4 * P2 + 8];
                ai[m][0] = tim[o];
                ai[m][1] = tim[o + 8];
                ai[m][2] = tim[o + 4 * P2];
                ai[m][3] = tim[o + 4 * P2 + 8];
            }
            const float* bp = outer + (8 * ks + t) * h1 + g;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                if (nt0 + n < nnt2) {
                    const float* p = bp + 8 * (nt0 + n);
                    const double bc[2] = {__ldg(p), __ldg(p + 4 * h1)};
                    const double bs[2] = {__ldg(p + L1 * h1),
                                          __ldg(p + L1 * h1 + 4 * h1)};
                    const double ns[2] = {-bs[0], -bs[1]};
#pragma unroll
                    for (int m = 0; m < 2; ++m) {
                        mma_m16n8k8_f64(xr[m][n], ar[m], bc);
                        mma_m16n8k8_f64(xr[m][n], ai[m], bs);
                        mma_m16n8k8_f64(xi[m][n], ai[m], bc);
                        mma_m16n8k8_f64(xi[m][n], ar[m], ns);
                    }
                }
            }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int k2 = 16 * (mt0 + m) + g + 8 * (q >> 1);
                    const int k1 = 8 * (nt0 + n) + 2 * t + (q & 1);
                    if (mt0 + m < nmt2 && nt0 + n < nnt2 && k2 < L2) {
                        const int k = k1 * L2 + k2;
                        const double sc = scale[k];
                        orow[k] = static_cast<uint8_t>(pack_nibbles(
                            xr[m][n][q] * sc, xi[m][n][q] * sc));
                    }
                }
            }
        }
    }
    __syncthreads();
    int4* dst = reinterpret_cast<int4*>(
        out + (static_cast<long long>(i) * nspec + s) * nchan);
    for (int q = tid; q < nchan / 16; q += THREADS) {
        dst[q] = reinterpret_cast<const int4*>(orow)[q];
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
    const size_t smem = factored_smem(L1, L2);
    auto kernel = pfb_factored_kernel<FAST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        return err;
    }
    // every 16 inputs of one sample are 16 aligned bytes
    const bool rows16 = sizeof(T) == 1 && st_i == 1 && st_t % 16 == 0
        && ninput % 16 == 0 && L % V_TN == 0
        && reinterpret_cast<uintptr_t>(adc) % 16 == 0;
    for (int s_first = 0; s_first < nspec; s_first += chunk) {
        const int nsc = chunk < nspec - s_first ? chunk : nspec - s_first;
        if (rows16) {
            const dim3 grid1(L / V_TN, nsc, (ninput + V_TI - 1) / V_TI);
            pfb_fir_rows16_kernel<FAST><<<grid1, THREADS, 0, stream>>>(
                static_cast<const int8_t*>(adc), st_t, ninput, s_first, L,
                ntap, static_cast<const float*>(window),
                static_cast<float*>(scratch), chunk);
        } else {
            const dim3 grid1(L / F_TN, nsc, (ninput + F_TI - 1) / F_TI);
            pfb_fir_rows_kernel<T, FAST><<<grid1, THREADS, 0, stream>>>(
                static_cast<const T*>(adc), st_t, st_i, ninput, s_first, L,
                ntap, static_cast<const float*>(window),
                static_cast<float*>(scratch), chunk);
        }
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
        || chunk > 65535 || ninput > 65535
        || factored_smem(L1, L2) > MAX_SHARED
        || reinterpret_cast<uintptr_t>(scratch) % 16 != 0
        || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
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
