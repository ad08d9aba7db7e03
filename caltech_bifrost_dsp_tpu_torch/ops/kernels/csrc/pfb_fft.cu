// Fused PFB channelizer + 4-bit requantizer as a factored real FFT in
// float64, for sm_90a: the pipeline-width lengths (nchan 192 and 96).
//
// Replaces, at those lengths and in the high-precision mode, the direct
// branch of caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py::
// pfb_quantize_packed_pallas (pallas_call at :434), which csrc/
// pfb_quantize.cu's pfb_direct_kernel computes as a folded DFT matrix
// product.  Same function, same output: for each (input i, spectrum s) row
//
//     fir[n]  = sum_{k < ntap} adc[(s + k) * L + n, i] * window[k, n]
//     X[c]    = sum_n fir[n] (cos - i sin)(2 pi n c / L),   c < nchan
//     out[i, s, c] = (q(Re X[c] * scale[c]) & 0xF) << 4 | (q(Im ...) & 0xF)
//     q(v)    = clamp(rint(v), -8, 7)
//
// with L = 2 nchan, ADC [ntime, ninput] int8 or float32 at its own strides
// and out input-major uint8 [ninput, nspec, nchan].  The bf16 mode is a
// DFT matrix product with bf16-rounded operands by definition, so it stays
// on the direct kernel.
//
// Precision.  The FIR row is formed as the direct kernel forms it: exact
// products in float64, summed over k, rounded once to float32 (by adding
// and subtracting 1.5 2^(e + 29), e the row value's exponent: the
// round-to-nearest-even of float32, without a conversion instruction).
// For int8 ADC each sample enters as the exact double 4096 + 128 + x,
// built from its biased byte with one byte permute, and the sum starts at
// -4224 sum_k window[k, n], so the sum is exact wherever the ntap window
// values of a sample lie within 2^14 of each other (all but one sample of
// the LWA window, where both kernels round in float64 below float32's
// precision).  The transform and v * scale are float64 with twiddles
// exact to an ulp; the bytes differ from the direct kernel's (float32 DFT
// tables) only at a rounding threshold.  No tensor-core, TF32 or bf16
// arithmetic.
//
// Transform.  L = 8 M.  Eight lanes own a row; lane j takes the M samples
// g[m] = fir[j + 8 m] and computes their real DFT R_j[q], q <= M/2, as a
// complex DFT of M/2 points (z[p] = g[2p] + i g[2p + 1]; radix 4, 3 and 2
// in registers, twiddles folded at compile time) and the real split.
// Then X[a + M b] = sum_j W_8^(j b) W_L^(j a) R_j[a]: for 0 < a < M/2 one
// complex DFT8 over the lanes gives both X[a + M b] and, through
// R_j[M - a] = conj R_j[a], X[M - a + M b] = conj D[7 - b] (b < 4).  The
// real bins a = 0 and a = M/2 of two rows go into one complex DFT8 each
// and are separated by symmetry, so that every lane runs three alike jobs
// (at M = 48), read from shared memory (the lanes' R as [lane][a] complex,
// pitch M/2 + 1).  At nchan 192: ~1e4 float64 operations a row, 1.7e10 a
// 2400-spectra window of 704 inputs (0.5 ms at the FP64 FMA rate), against
// 2.5e11 on the tensor cores for the folded DFT.  With one block of 8 warps
// an SM (its shared memory), latency more than the FP64 rate bounds it:
// each phase issues all of its loads before its first store, and the taps
// are unrolled at compile time for ntap 4.
//
// Loads.  A block owns 32 inputs (one 32-byte sector of each int8 sample)
// and a range of spectra, which it walks in order.  Its int8 frames sit in
// a ring of ntap + 3 frames in shared memory, transposed to [4-input word]
// [sample], so that a lane's word holds one sample of its warp's four
// inputs.  Frame s + ntap + 2 is loaded into registers (16-byte loads where
// the ADC allows, bytes otherwise) while spectrum s is transformed, and is
// stored into the ring at the next spectrum, two spectra before its first
// read, so that the block meets at a barrier every second spectrum only;
// nothing goes to device memory but the packed bytes.  Each warp owns four inputs: it forms their FIR rows
// (a lane takes 12 samples of all four from one 32-bit word per tap),
// transforms them and writes each 192-byte row in 16-byte pieces.  The
// grid is one wave: 22 input tiles x 6 ranges of 400 spectra at the
// production shape.  float32 ADC reads its samples from device memory
// (no ring); it takes this kernel in tests and smoke runs only.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FFT_THREADS = 256;
constexpr int FFT_WARPS = FFT_THREADS / 32;
constexpr int FFT_TI = 32;              // inputs a block
constexpr int FFT_MAX_SHARED = 232448;  // bytes one block may use
constexpr int FFT_SYNC = 2;             // spectra between block barriers

struct cplx {
    double re, im;
};

// exp(-2 pi i e / n), exact at multiples of a quarter turn; the reduced
// angle is at most pi / 4, where 12 Taylor terms are exact to an ulp
__host__ __device__ constexpr double sin_poly(double x)
{
    double term = x, sum = x;
    for (int k = 1; k < 12; ++k) {
        term *= -x * x / ((2 * k) * (2 * k + 1));
        sum += term;
    }
    return sum;
}

__host__ __device__ constexpr double cos_poly(double x)
{
    double term = 1.0, sum = 1.0;
    for (int k = 1; k < 12; ++k) {
        term *= -x * x / ((2 * k - 1) * (2 * k));
        sum += term;
    }
    return sum;
}

__host__ __device__ constexpr cplx unit_root(int e, int n)
{
    e %= n;
    if (e < 0) {
        e += n;
    }
    const int q = 4 * e / n;
    const int r = 4 * e - q * n;            // angle (q + r / n) pi / 2
    double c = 1.0, s = 0.0;
    if (r != 0) {
        const bool flip = 2 * r > n;
        const double x = 1.5707963267948966 * (flip ? n - r : r) / n;
        c = flip ? sin_poly(x) : cos_poly(x);
        s = flip ? cos_poly(x) : sin_poly(x);
    }
    double cq = c, sq = s;
    if (q == 1) {
        cq = -s;
        sq = c;
    } else if (q == 2) {
        cq = -c;
        sq = -s;
    } else if (q == 3) {
        cq = s;
        sq = -c;
    }
    return cplx{cq, -sq};
}

template <int N>
struct Roots {
    cplx w[N];
    __host__ __device__ constexpr Roots() : w()
    {
        for (int e = 0; e < N; ++e) {
            w[e] = unit_root(e, N);
        }
    }
};

__device__ __forceinline__ cplx cmul(cplx a, cplx b)
{
    return cplx{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ __forceinline__ cplx cadd(cplx a, cplx b)
{
    return cplx{a.re + b.re, a.im + b.im};
}

__device__ __forceinline__ cplx csub(cplx a, cplx b)
{
    return cplx{a.re - b.re, a.im - b.im};
}

// x W_N^e for a compile-time e after unrolling: a quarter turn is a swap
template <int N>
__device__ __forceinline__ cplx rotate(cplx x, int e, const Roots<N>& w)
{
    e %= N;
    if (e == 0) {
        return x;
    }
    if (4 * e == N) {
        return cplx{x.im, -x.re};
    }
    if (2 * e == N) {
        return cplx{-x.re, -x.im};
    }
    if (4 * e == 3 * N) {
        return cplx{-x.im, x.re};
    }
    return cmul(x, w.w[e]);
}

// In-place DFT of N complex points in registers, natural order in and
// out: X[k] = sum_n x[n] W_N^(n k).  Decimation in time by 4, 3 or 2.
template <int N>
__device__ __forceinline__ void cdft(cplx (&x)[N])
{
    if constexpr (N == 2) {
        const cplx a = x[0], b = x[1];
        x[0] = cadd(a, b);
        x[1] = csub(a, b);
    } else if constexpr (N == 3) {
        constexpr double H3 = 0.8660254037844386;     // sin(pi / 3)
        const cplx t1 = cadd(x[1], x[2]);
        const cplx t2 = csub(x[1], x[2]);
        const cplx x0 = x[0];
        const cplx m{x0.re - 0.5 * t1.re, x0.im - 0.5 * t1.im};
        const cplx r{H3 * t2.im, -H3 * t2.re};        // -i sin(pi/3) t2
        x[0] = cadd(x0, t1);
        x[1] = cadd(m, r);
        x[2] = csub(m, r);
    } else if constexpr (N == 4) {
        const cplx s02 = cadd(x[0], x[2]), d02 = csub(x[0], x[2]);
        const cplx s13 = cadd(x[1], x[3]), d13 = csub(x[1], x[3]);
        const cplx md13{d13.im, -d13.re};             // -i d13
        x[0] = cadd(s02, s13);
        x[2] = csub(s02, s13);
        x[1] = cadd(d02, md13);
        x[3] = csub(d02, md13);
    } else {
        constexpr int R = N % 4 == 0 ? 4 : (N % 3 == 0 ? 3 : 2);
        constexpr int S = N / R;
        constexpr Roots<N> w{};
        cplx y[R][S];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int m = 0; m < S; ++m) {
                y[r][m] = x[R * m + r];
            }
            cdft<S>(y[r]);
        }
#pragma unroll
        for (int k1 = 0; k1 < S; ++k1) {
            cplx t[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                t[r] = rotate<N>(y[r][k1], r * k1, w);
            }
            cdft<R>(t);
#pragma unroll
            for (int k2 = 0; k2 < R; ++k2) {
                x[k1 + S * k2] = t[k2];
            }
        }
    }
}

// v rounded to float32 (nearest, ties to even), kept as a double: the ulp
// of 1.5 2^(e + 29) is float32's ulp in v's binade e
__device__ __forceinline__ double round_to_float(double v)
{
    const int hi = __double2hiint(v);
    const double big = __hiloint2double((hi & 0x7ff00000) + 0x01d80000, 0);
    return (v + big) - big;
}

// one tap of the int8 FIR of four inputs: the biased byte c of ``word`` as
// the hi word's mantissa bits 8-15 under exponent 12 is 4096 + (x + 128)
__device__ __forceinline__ void fir_tap(uint32_t word, double wk,
                                        double (&acc)[4])
{
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int hi = static_cast<int>(
            __byte_perm(word, 0x40B00000u, 0x7604u | (c << 4)));
        acc[c] = fma(__hiloint2double(hi, 0), wk, acc[c]);
    }
}

// clamp(rint(v), -8, 7) without float64 min/max: t = v + 1.5 2^52 holds
// rint(v) (ties to even) as x in its mantissa where |v| < 2^51; x is the
// low word where the high word is 0x43380000 (0 <= x < 2^31) or 0x4337ffff
// (-2^31 <= x < 0), and elsewhere the high word, as a signed integer,
// orders t against 1.5 2^52 and so gives the side to clamp to
__device__ __forceinline__ int quant(double v)
{
    const double t = v + 6755399441055744.0;
    const int hi = __double2hiint(t);
    const int lo = __double2loint(t);
    const int in = min(max(lo, -8), 7);
    const int out = hi < 0x43380000 ? -8 : 7;
    return hi == 0x43380000 + (lo >> 31) ? in : out;
}

__device__ __forceinline__ int pack_code(cplx v, double sc)
{
    return ((quant(v.re * sc) & 0xF) << 4) | (quant(v.im * sc) & 0xF);
}

// Shared memory of the kernel at M and ntap: per warp the FIR rows
// (doubles [4][L + 8]), which the lanes' transforms [32][M/2 + 1] complex
// overwrite, and the packed rows [4][nchan + 16]; the window [ntap][L] and
// its offsets [L] as doubles; the twiddles [8][M/2 + 1] complex; the
// halved scale [nchan]; for int8, the ring of ntap + 3 frames [8][L + 4]
// words.
__host__ __device__ constexpr size_t fft_smem(int M, int ntap, bool ring)
{
    const size_t L = 8 * static_cast<size_t>(M);
    const size_t H = M / 2;
    const size_t fir = 4 * (L + 8) * 8, xs = 32 * (H + 1) * 16;
    const size_t warp = (fir > xs ? fir : xs) + 4 * (4 * M + 16);
    return FFT_WARPS * warp + (static_cast<size_t>(ntap) + 1) * L * 8
        + 8 * (H + 1) * 16 + 4 * M * 8
        + (ring ? (static_cast<size_t>(ntap) + 2 * FFT_SYNC - 1) * 8
                      * (L + 4) * 4 : 0);
}

// NT: the tap count unrolled at compile time (4, the pipeline's), or 0 for
// a loop over ``ntap``; ``vec``: every 16 inputs of one int8 sample are 16
// aligned bytes
template <int M, typename T, int NT>
__global__ void __launch_bounds__(FFT_THREADS, 1)
pfb_fft_kernel(const T* __restrict__ adc, long long st_t, long long st_i,
               int vec, int ninput, int nspec, int ntap, int nchunk,
               const float* __restrict__ window,
               const double* __restrict__ twiddle,
               const float* __restrict__ scale, uint8_t* __restrict__ out)
{
    constexpr int L = 8 * M;
    constexpr int H = M / 2;
    constexpr int NCHAN = 4 * M;
    constexpr int FP = L + 8;              // FIR row pitch, doubles
    constexpr int XP = H + 1;              // a lane's transform, complex
    constexpr int OP = NCHAN + 16;         // packed row pitch, bytes
    constexpr int RP = L + 4;              // ring row pitch, words
    constexpr int WARP_BYTES = (4 * FP * 8 > 32 * XP * 16 ? 4 * FP * 8
                                                           : 32 * XP * 16);
    constexpr bool RING = sizeof(T) == 1;
    static_assert(M % 4 == 0 && NCHAN % 16 == 0, "unsupported length");

    extern __shared__ float4 smem4[];
    unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    double* fir = reinterpret_cast<double*>(base + warp * WARP_BYTES);
    cplx* xs = reinterpret_cast<cplx*>(fir);
    uint8_t* ob = base + FFT_WARPS * WARP_BYTES + warp * 4 * OP;
    double* wd = reinterpret_cast<double*>(base + FFT_WARPS
                                           * (WARP_BYTES + 4 * OP));
    double* sd = wd + ntap * L;
    cplx* tw = reinterpret_cast<cplx*>(sd + L);
    double* sch = reinterpret_cast<double*>(tw + 8 * XP);
    uint32_t* ring = reinterpret_cast<uint32_t*>(sch + NCHAN);
    // a frame is stored FFT_SYNC spectra before its first read and
    // overwrites the frame first read FFT_SYNC spectra earlier: a barrier
    // lies between each store and the reads on either side of it
    const int nring = ntap + 2 * FFT_SYNC - 1;

    const int ntile = (ninput + FFT_TI - 1) / FFT_TI;
    const int i0 = static_cast<int>(blockIdx.x % ntile) * FFT_TI;
    const int chunk = static_cast<int>(blockIdx.x / ntile);
    const int per = (nspec + nchunk - 1) / nchunk;
    const int s_lo = chunk * per;
    const int s_hi = min(nspec, s_lo + per);
    if (s_lo >= s_hi) {
        return;
    }
    // the last frame this block reads
    const int f_end = s_hi + ntap - 1;

    for (int e = tid; e < ntap * L; e += FFT_THREADS) {
        wd[e] = static_cast<double>(window[e]);
    }
    for (int n = tid; n < L; n += FFT_THREADS) {
        // int8 samples enter as 4224 + x: start each sum at -4224 sum_k w
        double acc = 0.0;
        for (int k = 0; k < ntap; ++k) {
            acc -= 4224.0 * static_cast<double>(window[k * L + n]);
        }
        sd[n] = RING ? acc : 0.0;
    }
    for (int e = tid; e < 8 * XP; e += FFT_THREADS) {
        tw[e] = cplx{twiddle[2 * e], twiddle[2 * e + 1]};
    }
    for (int c = tid; c < NCHAN; c += FFT_THREADS) {
        // the transform below carries 2 X: halve the gain, exactly
        sch[c] = 0.5 * static_cast<double>(scale[c]);
    }

    // the ring: thread item (sample n, half h) holds 16 inputs of one
    // sample as four words, biased by 0x80 a byte (the int8 value + 128)
    constexpr int NITEM = (2 * L + FFT_THREADS - 1) / FFT_THREADS;
    int4 pre[NITEM];
    auto fetch = [&](int f) {
#pragma unroll
        for (int u = 0; u < NITEM; ++u) {
            const int item = tid + u * FFT_THREADS;
            const int n = item >> 1;
            const int h = item & 1;
            int4 v{0, 0, 0, 0};
            if (item < 2 * L && f < f_end && i0 + 16 * h < ninput) {
                const long long t = static_cast<long long>(f) * L + n;
                if (vec) {
                    v = __ldg(reinterpret_cast<const int4*>(
                        adc + t * st_t + i0 + 16 * h));
                } else {
                    int words[4] = {0, 0, 0, 0};
#pragma unroll
                    for (int e = 0; e < 16; ++e) {
                        const int i = i0 + 16 * h + e;
                        const int b = i < ninput
                            ? static_cast<int>(adc[t * st_t + i * st_i]) : 0;
                        words[e >> 2] |= (b & 0xFF) << (8 * (e & 3));
                    }
                    v = int4{words[0], words[1], words[2], words[3]};
                }
            }
            pre[u] = v;
        }
    };
    auto store = [&](int f) {
        uint32_t* slot = ring + (f % nring) * 8 * RP;
#pragma unroll
        for (int u = 0; u < NITEM; ++u) {
            const int item = tid + u * FFT_THREADS;
            if (item < 2 * L) {
                const int n = item >> 1;
                const int h = item & 1;
                const int words[4] = {pre[u].x, pre[u].y, pre[u].z,
                                      pre[u].w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    slot[(4 * h + c) * RP + n] =
                        static_cast<uint32_t>(words[c]) ^ 0x80808080u;
                }
            }
        }
    };
    if constexpr (RING) {
        for (int f = s_lo; f < s_lo + ntap + FFT_SYNC - 1; ++f) {
            fetch(f);
            store(f);
        }
        fetch(s_lo + ntap + FFT_SYNC - 1);
    }

    const int r = lane >> 3;     // the lane's row (input i0 + 4 warp + r)
    const int j = lane & 7;      // and its place in the row's transform
    for (int s = s_lo; s < s_hi; ++s) {
        // at a barrier the frames of the next FFT_SYNC spectra have
        // landed, and every warp is done with the spectra whose first
        // frames' slots the next FFT_SYNC stores take
        if ((s - s_lo) % FFT_SYNC == 0) {
            __syncthreads();
        }
        if constexpr (RING) {
            store(s + ntap + FFT_SYNC - 1);
            fetch(s + ntap + FFT_SYNC);
        }

        // FIR rows of the warp's four inputs: lane takes samples
        // 32 g + lane of all four, three samples' loads issued before
        // their stores
        {
            int off[NT > 0 ? NT : 1];
            if constexpr (RING && NT > 0) {
#pragma unroll
                for (int k = 0; k < NT; ++k) {
                    off[k] = ((s + k) % nring) * 8 * RP + warp * RP;
                }
            }
#pragma unroll 3
            for (int g = 0; g < M / 4; ++g) {
                const int n = 32 * g + lane;
                double acc[4];
                if constexpr (RING) {
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        acc[c] = sd[n];
                    }
                    if constexpr (NT > 0) {
#pragma unroll
                        for (int k = 0; k < NT; ++k) {
                            fir_tap(ring[off[k] + n], wd[k * L + n], acc);
                        }
                    } else {
                        for (int k = 0; k < ntap; ++k) {
                            fir_tap(ring[((s + k) % nring) * 8 * RP
                                         + warp * RP + n],
                                    wd[k * L + n], acc);
                        }
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        acc[c] = 0.0;
                        const int i = min(i0 + 4 * warp + c, ninput - 1);
                        for (int k = 0; k < ntap; ++k) {
                            const long long t =
                                static_cast<long long>(s + k) * L + n;
                            acc[c] = fma(static_cast<double>(
                                             adc[t * st_t + i * st_i]),
                                         wd[k * L + n], acc[c]);
                        }
                    }
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    fir[c * FP + n] = round_to_float(acc[c]);
                }
            }
        }
        __syncwarp();

        // stage 1: lane j's real DFT of g[m] = fir[j + 8 m], as M/2
        // complex points and the real split; slot 0 holds the two real
        // bins (R[0], R[M/2]), slot q < M/2 holds R[q]; all scaled by 2
        {
            cplx z[H];
            const double* row = fir + r * FP + j;
#pragma unroll
            for (int p = 0; p < H; ++p) {
                z[p] = cplx{row[16 * p], row[16 * p + 8]};
            }
            __syncwarp();        // the rows are read before xs takes them
            cdft<H>(z);
            constexpr Roots<M> wm{};
            cplx* dst = xs + (r * 8 + j) * XP;
            dst[0] = cplx{2.0 * (z[0].re + z[0].im),
                          2.0 * (z[0].re - z[0].im)};
#pragma unroll
            for (int q = 1; 2 * q <= H; ++q) {
                const cplx a = z[q], b = z[H - q];
                const cplx e{a.re + b.re, a.im - b.im};      // a + conj b
                const cplx o{a.im + b.im, b.re - a.re};      // -i (a - conj b)
                const cplx p = rotate<M>(o, q, wm);
                dst[q] = cadd(e, p);
                if (2 * q != H) {
                    dst[H - q] = cplx{e.re - p.re, p.im - e.im};
                }
            }
        }
        __syncwarp();

        // stage 2: job a of lane j is a DFT8 over the row's lanes.  Job 0
        // packs the real bins of two rows as one complex sequence: lane
        // (r, 0) takes R[0] (r even) or R[M/2] (r odd) of rows r & ~1 and
        // (r & ~1) + 1, and separates the two rows' outputs by symmetry.
        // Each code is kept with its place until every load is done.
        {
            constexpr int NJOB = (H + 7) / 8;
            int code[NJOB][8];
#pragma unroll
            for (int t = 0; t < NJOB; ++t) {
                const int a = j + 8 * t;
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    code[t][e] = -1;
                }
                if (a >= H) {
                    continue;
                }
                const bool pair = a == 0;
                const int odd = r & 1;
                const int ra = pair ? r - odd : r;
                const int rb = pair ? ra + 1 : r;
                const int col = pair ? odd * H : a;
                const double* p = reinterpret_cast<const double*>(
                    xs + ra * 8 * XP + a) + (pair ? odd : 0);
                const double* q = reinterpret_cast<const double*>(
                    xs + rb * 8 * XP + a) + (pair ? odd : 1);
                cplx v[8];
#pragma unroll
                for (int l = 0; l < 8; ++l) {
                    v[l] = cplx{p[2 * l * XP], q[2 * l * XP]};
                    if (l > 0) {
                        v[l] = cmul(v[l], tw[l * XP + col]);
                    }
                }
                cdft<8>(v);
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    // rows: X[a + M b] = D[b], X[M - a + M b] = conj
                    // D[7 - b]; a pair: the two rows' bins from D[b] and
                    // conj D[8 - b] (R[0]) or conj D[7 - b] (R[M/2])
                    cplx x1 = v[b];
                    cplx x2{v[7 - b].re, -v[7 - b].im};
                    int c1 = a + M * b, c2 = M - a + M * b;
                    if (pair) {
                        const cplx f = odd ? x2
                            : cplx{v[(8 - b) & 7].re, -v[(8 - b) & 7].im};
                        const cplx d = csub(v[b], f);
                        x1 = cplx{0.5 * (v[b].re + f.re),
                                  0.5 * (v[b].im + f.im)};
                        x2 = cplx{0.5 * d.im, -0.5 * d.re};
                        c1 = odd * H + M * b;
                        c2 = c1;
                    }
                    code[t][2 * b] = (ra * OP + c1) << 8
                                     | pack_code(x1, sch[c1]);
                    code[t][2 * b + 1] = (rb * OP + c2) << 8
                                         | pack_code(x2, sch[c2]);
                }
            }
#pragma unroll
            for (int t = 0; t < NJOB; ++t) {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    if (code[t][e] >= 0) {
                        ob[code[t][e] >> 8] =
                            static_cast<uint8_t>(code[t][e] & 0xFF);
                    }
                }
            }
        }
        __syncwarp();

        // the four packed rows, 16 bytes a store
        for (int e = lane; e < 4 * (NCHAN / 16); e += 32) {
            const int row = e / (NCHAN / 16);
            const int q = e % (NCHAN / 16);
            const int i = i0 + 4 * warp + row;
            if (i < ninput) {
                reinterpret_cast<int4*>(
                    out + (static_cast<long long>(i) * nspec + s) * NCHAN)[q]
                    = reinterpret_cast<const int4*>(ob + row * OP)[q];
            }
        }
    }
}

template <int M, typename T, int NT>
cudaError_t launch_fft(const void* adc, long long st_t, long long st_i,
                       int vec, int ninput, int nspec, int ntap,
                       const void* window, const void* twiddle,
                       const void* scale, void* out, cudaStream_t stream)
{
    const size_t smem = fft_smem(M, ntap, sizeof(T) == 1);
    auto kernel = pfb_fft_kernel<M, T, NT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        return err;
    }
    // one wave: input tiles x ranges of spectra to fill the resident slots
    int dev = 0, nsm = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, FFT_THREADS, smem)) != cudaSuccess) {
        return err;
    }
    const int ntile = (ninput + FFT_TI - 1) / FFT_TI;
    const int slots = nsm * (per_sm > 0 ? per_sm : 1);
    const int nchunk = max(1, min(nspec, slots / ntile));
    const long long nblock = static_cast<long long>(ntile) * nchunk;
    if (nblock > 2147483647LL) {
        return cudaErrorInvalidValue;
    }
    kernel<<<dim3(static_cast<unsigned>(nblock)), FFT_THREADS, smem,
             stream>>>(
        static_cast<const T*>(adc), st_t, st_i, vec, ninput, nspec, ntap,
        nchunk, static_cast<const float*>(window),
        static_cast<const double*>(twiddle),
        static_cast<const float*>(scale), static_cast<uint8_t*>(out));
    return cudaGetLastError();
}

template <int M>
cudaError_t launch_fft_length(const void* adc, long long st_t,
                              long long st_i, int is_int8, int ninput,
                              int nspec, int ntap, const void* window,
                              const void* twiddle, const void* scale,
                              void* out, cudaStream_t stream)
{
    if (fft_smem(M, ntap, is_int8) > FFT_MAX_SHARED) {
        return cudaErrorInvalidValue;
    }
    if (!is_int8) {
        return launch_fft<M, float, 0>(adc, st_t, st_i, 0, ninput, nspec,
                                       ntap, window, twiddle, scale, out,
                                       stream);
    }
    const int vec = st_i == 1 && st_t % 16 == 0 && ninput % 16 == 0
        && reinterpret_cast<uintptr_t>(adc) % 16 == 0;
    if (ntap == 4) {
        return launch_fft<M, int8_t, 4>(adc, st_t, st_i, vec, ninput, nspec,
                                        ntap, window, twiddle, scale, out,
                                        stream);
    }
    return launch_fft<M, int8_t, 0>(adc, st_t, st_i, vec, ninput, nspec,
                                    ntap, window, twiddle, scale, out,
                                    stream);
}

}  // namespace

// adc: [ntime, ninput] int8 (is_int8) or float32 with element strides
// st_t, st_i; nchan 192 or 96; window f32 [ntap][2 nchan]; twiddle f64
// [8][nchan / 8 + 1][re, im] = W_L^(j a) (ops/pfb_fused.py::
// fft_twiddles_ref); scale f32 [nchan]; out uint8 [ninput][nspec][nchan],
// 16-byte aligned.  Returns the CUDA error of the launch.
extern "C" int cbd_pfb_fft(const void* adc, long long st_t, long long st_i,
                           int is_int8, int ninput, int nspec, int nchan,
                           int ntap, const void* window, const void* twiddle,
                           const void* scale, void* out, void* stream)
{
    if (ninput <= 0 || nspec <= 0 || ntap <= 0
        || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (nchan == 192) {
        err = launch_fft_length<48>(adc, st_t, st_i, is_int8, ninput, nspec,
                                    ntap, window, twiddle, scale, out, s);
    } else if (nchan == 96) {
        err = launch_fft_length<24>(adc, st_t, st_i, is_int8, ninput, nspec,
                                    ntap, window, twiddle, scale, out, s);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
