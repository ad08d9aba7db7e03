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
// Precision.  The DFT runs in float32 FMA (never TF32, which would flip
// many rounding decisions).  Partial sums are float32 over 32-term slices
// of the contraction and are added into a float64 accumulator after each
// slice, and v * scale is formed in float64: that keeps the error against
// the float64 reference near 3e-7 of a code, against ~1e-6 for one long
// float32 sum, so fewer values land on the other side of a rounding
// threshold.  fast=1 (the TPU kernel's bf16 mode, pfb_fused.py:95-102)
// rounds the DFT operands to bf16 with __float2bfloat16_rn where the TPU
// kernel casts: the FIR frames, the tables (rounded by the wrapper) and,
// in the factored transform, the twiddled intermediates (:269-276); the
// products are then exact in float32.
//
// Direct mode (L < 2048; production L = 384).  A block owns 32 inputs x 2
// spectra = 64 rows.  Its FIR rows go to shared memory (transposed, the
// contraction index outer) and never to device memory; 32 inputs of one
// ADC sample are one 32-byte sector of int8, so the FIR reads coalesce.
// The [L, 2 * nchan] table (columns interleaved re, im per channel,
// 576 KB at nchan = 192) stays resident in L2 and is streamed through
// shared memory in 32 x 128 tiles.  Each thread holds an 8-row x 4-column
// register tile.  Bound: fp32 FMA issue, 5.0e11 flop per 2400-spectra
// window at 704 inputs (7.5 ms at the card's fp32 peak); the FIR (4 FMA
// per sample) and the 650 MB int8 ADC read are a few percent of that.
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
constexpr int D_TI = 32;              // inputs per block
constexpr int D_TS = 2;               // spectra per block
constexpr int D_BM = D_TI * D_TS;     // rows per block
constexpr int D_BK = 32;              // contraction slice
constexpr int D_BN = 128;             // output-column tile
constexpr int D_TM = 8;               // rows per thread
constexpr int D_TN = 4;               // columns per thread (2 channels)

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

template <typename T, bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
pfb_direct_kernel(const T* __restrict__ adc, long long st_t, long long st_i,
                  int ninput, int nspec, int nchan, int ntap,
                  const float* __restrict__ window,
                  const float* __restrict__ table, int kpad, int npad,
                  const float* __restrict__ scale, uint8_t* __restrict__ out)
{
    extern __shared__ float4 smem4[];
    float* fir = reinterpret_cast<float*>(smem4);     // [kpad][D_BM]
    float* btile = fir + kpad * D_BM;                 // [D_BK][D_BN]
    const int L = 2 * nchan;
    const int tid = threadIdx.x;
    const int s0 = blockIdx.x * D_TS;
    const int i0 = blockIdx.y * D_TI;

    // FIR of row r = si * D_TI + ii into fir[n][r]; zero past the edges
    {
        const int ii = tid % D_TI;
        const int i = i0 + ii;
        for (int n = tid / D_TI; n < kpad; n += THREADS / D_TI) {
            for (int si = 0; si < D_TS; ++si) {
                const int s = s0 + si;
                float v = 0.f;
                if (i < ninput && s < nspec && n < L) {
                    v = fir_sample<T, FAST>(adc, st_t, st_i, window, ntap, L,
                                            static_cast<long long>(s) * L, n,
                                            i);
                }
                fir[n * D_BM + si * D_TI + ii] = v;
            }
        }
    }

    const int tx = tid % (D_BN / D_TN);   // column group
    const int ty = tid / (D_BN / D_TN);   // row group
    const float4* fir4 = reinterpret_cast<const float4*>(fir);
    float4* b4 = reinterpret_cast<float4*>(btile);
    for (int c0 = 0; c0 < npad; c0 += D_BN) {
        double acc64[D_TM][D_TN];
#pragma unroll
        for (int m = 0; m < D_TM; ++m) {
#pragma unroll
            for (int n = 0; n < D_TN; ++n) {
                acc64[m][n] = 0.0;
            }
        }
        for (int k0 = 0; k0 < kpad; k0 += D_BK) {
            __syncthreads();   // FIR written; previous table tile consumed
            for (int q = tid; q < D_BK * D_BN / 4; q += THREADS) {
                const int kk = q / (D_BN / 4);
                const int cc = q % (D_BN / 4);
                b4[q] = reinterpret_cast<const float4*>(
                    table + static_cast<long long>(k0 + kk) * npad + c0)[cc];
            }
            __syncthreads();
            float acc[D_TM][D_TN];
#pragma unroll
            for (int m = 0; m < D_TM; ++m) {
#pragma unroll
                for (int n = 0; n < D_TN; ++n) {
                    acc[m][n] = 0.f;
                }
            }
#pragma unroll 4
            for (int kk = 0; kk < D_BK; ++kk) {
                const int ai = ((k0 + kk) * D_BM + ty * D_TM) / 4;
                const float4 a0 = fir4[ai];
                const float4 a1 = fir4[ai + 1];
                const float4 b = b4[kk * (D_BN / 4) + tx];
                const float a[D_TM] = {a0.x, a0.y, a0.z, a0.w,
                                       a1.x, a1.y, a1.z, a1.w};
                const float bb[D_TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int m = 0; m < D_TM; ++m) {
#pragma unroll
                    for (int n = 0; n < D_TN; ++n) {
                        acc[m][n] = fmaf(a[m], bb[n], acc[m][n]);
                    }
                }
            }
#pragma unroll
            for (int m = 0; m < D_TM; ++m) {
#pragma unroll
                for (int n = 0; n < D_TN; ++n) {
                    acc64[m][n] += static_cast<double>(acc[m][n]);
                }
            }
        }
        // requantize and pack: columns 2c, 2c + 1 are Re, Im of channel c
#pragma unroll
        for (int m = 0; m < D_TM; ++m) {
            const int r = ty * D_TM + m;
            const int i = i0 + r % D_TI;
            const int s = s0 + r / D_TI;
            if (i >= ninput || s >= nspec) {
                continue;
            }
            uint8_t* row = out + (static_cast<long long>(i) * nspec + s)
                                 * nchan;
#pragma unroll
            for (int p = 0; p < D_TN / 2; ++p) {
                const int c = (c0 + tx * D_TN) / 2 + p;
                if (c < nchan) {
                    const double sc = scale[c];
                    row[c] = static_cast<uint8_t>(pack_nibbles(
                        acc64[m][2 * p] * sc, acc64[m][2 * p + 1] * sc));
                }
            }
        }
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

template <typename T, bool FAST>
cudaError_t launch_direct(const void* adc, long long st_t, long long st_i,
                          int ninput, int nspec, int nchan, int ntap,
                          const void* window, const void* table, int kpad,
                          int npad, const void* scale, void* out,
                          cudaStream_t stream)
{
    const size_t smem = (static_cast<size_t>(kpad) * D_BM + D_BK * D_BN)
                        * sizeof(float);
    auto kernel = pfb_direct_kernel<T, FAST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        return err;
    }
    const dim3 grid((nspec + D_TS - 1) / D_TS, (ninput + D_TI - 1) / D_TI);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(adc), st_t, st_i, ninput, nspec, nchan, ntap,
        static_cast<const float*>(window), static_cast<const float*>(table),
        kpad, npad, static_cast<const float*>(scale),
        static_cast<uint8_t*>(out));
    return cudaGetLastError();
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
// st_t, st_i; window f32 [ntap][2 nchan]; table f32 [kpad][npad] (see
// ops/pfb_fused.py::_direct_table); scale f32 [nchan]; out uint8
// [ninput][nspec][nchan].  Returns the CUDA error of the launch.
extern "C" int cbd_pfb_direct(const void* adc, long long st_t,
                              long long st_i, int is_int8, int ninput,
                              int nspec, int nchan, int ntap,
                              const void* window, const void* table,
                              int kpad, int npad, const void* scale,
                              int fast, void* out, void* stream)
{
    const int L = 2 * nchan;
    if (ninput <= 0 || nspec <= 0 || ntap <= 0 || kpad < L
        || kpad % D_BK != 0 || npad < L || npad % D_BN != 0
        || ninput > 65535 * D_TI) {
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
