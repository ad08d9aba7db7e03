// Correlator with the accumulator algebra fused in, for sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py::
// packed_corr_blk_acc (256-block triangular int8 Karatsuba correlator).
//
// One block computes one channel's T x T tile pair (ti <= tj) of the
// visibility matrix over the whole time window, then applies the
// integration-boundary algebra in place on the state planes:
//
//     fast = gulp            if fast_first else fast + gulp
//     slow = unchanged       if not fast_last
//          = copy of fast    if slow_first
//          = slow + fast     otherwise
//
// Arithmetic: each block stages TCHUNK time samples of its two 64-input
// tiles in shared memory, unpacked from 4+4 bits to signed bytes and packed
// four time samples to an int, so one __dp4a contracts four samples.  The
// imaginary part uses the 3-product Karatsuba of corr_blk.py:14-18:
// P1 = ar.br, P2 = ai.bi, P3 = (ai - ar).(br + bi); vr = P1 + P2,
// vi = P3 + P1 - P2.  The combination planes fit int8 (ai - ar in [-15, 15],
// br + bi in [-16, 14]) and int32 sums stay exact for any realistic window.
//
// Bound: at 704 inputs, 192 channels and 2400 spectra a window is about
// 0.5 T int8 multiply-adds on the upper tiles, so this kernel is bound by
// integer issue rate (dp4a and shared-memory loads), not by the ~1.5 GB of
// state it reads and writes.  Each thread holds a 4 x 4 output tile and
// reads its operands as 16-byte shared-memory vectors to keep the ratio of
// dp4a to loads at 2:1.  Tensor-core int8 MMA is the later step.
//
// Contract: entries j >= i are valid (diagonal tiles are computed whole);
// entries in tiles below the diagonal are never written.  Time samples
// past ntime and inputs past ninput read as zero; pad lanes of a padded
// input axis are never read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;            // inputs per tile side
constexpr int TCHUNK = 32;          // time samples staged per iteration
constexpr int NQ = TCHUNK / 4;      // packed 4-sample words per input
constexpr int THREADS = 256;        // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ int sext4(unsigned v) {
    return static_cast<int>(v ^ 8u) - 8;
}

__global__ void __launch_bounds__(THREADS)
corr_acc_kernel(const uint8_t* __restrict__ packed, long long stride_c,
                long long stride_t, int ntime, int ninput, int ntile,
                int* __restrict__ fast_r, int* __restrict__ fast_i,
                int* __restrict__ slow_r, int* __restrict__ slow_i,
                int fast_first, int fast_last, int slow_first)
{
    // upper tile pair (ti <= tj), enumerated row by row
    int p = blockIdx.x;
    int ti = 0;
    while (p >= ntile - ti) {
        p -= ntile - ti;
        ++ti;
    }
    const int tj = ti + p;
    const int c = blockIdx.y;
    const int i0 = ti * TILE;
    const int j0 = tj * TILE;

    // [plane][word][input]; row side planes re, im, im-re;
    // column side planes re, im, re+im
    __shared__ __align__(16) int a_sh[3][NQ][TILE];
    __shared__ __align__(16) int b_sh[3][NQ][TILE];

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;

    int p1[4][4], p2[4][4], p3[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            p1[m][n] = 0;
            p2[m][n] = 0;
            p3[m][n] = 0;
        }
    }

    const uint8_t* base = packed + static_cast<long long>(c) * stride_c;

    for (int t0 = 0; t0 < ntime; t0 += TCHUNK) {
        for (int item = tid; item < 2 * NQ * TILE; item += THREADS) {
            const int side = item / (NQ * TILE);
            const int rem = item - side * (NQ * TILE);
            const int q = rem / TILE;
            const int k = rem - q * TILE;
            const int in = (side ? j0 : i0) + k;
            unsigned re4 = 0, im4 = 0, cb4 = 0;
            if (in < ninput) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int t = t0 + 4 * q + u;
                    int re = 0, im = 0;
                    if (t < ntime) {
                        const unsigned b = base[static_cast<long long>(t)
                                                * stride_t + in];
                        re = sext4(b >> 4);
                        im = sext4(b & 15u);
                    }
                    const int cb = side ? (re + im) : (im - re);
                    re4 |= (static_cast<unsigned>(re) & 0xFFu) << (8 * u);
                    im4 |= (static_cast<unsigned>(im) & 0xFFu) << (8 * u);
                    cb4 |= (static_cast<unsigned>(cb) & 0xFFu) << (8 * u);
                }
            }
            if (side) {
                b_sh[0][q][k] = static_cast<int>(re4);
                b_sh[1][q][k] = static_cast<int>(im4);
                b_sh[2][q][k] = static_cast<int>(cb4);
            } else {
                a_sh[0][q][k] = static_cast<int>(re4);
                a_sh[1][q][k] = static_cast<int>(im4);
                a_sh[2][q][k] = static_cast<int>(cb4);
            }
        }
        __syncthreads();

#pragma unroll 2
        for (int q = 0; q < NQ; ++q) {
            const int4 ar = *reinterpret_cast<const int4*>(&a_sh[0][q][4 * ty]);
            const int4 ai = *reinterpret_cast<const int4*>(&a_sh[1][q][4 * ty]);
            const int4 ad = *reinterpret_cast<const int4*>(&a_sh[2][q][4 * ty]);
            const int4 br = *reinterpret_cast<const int4*>(&b_sh[0][q][4 * tx]);
            const int4 bi = *reinterpret_cast<const int4*>(&b_sh[1][q][4 * tx]);
            const int4 bs = *reinterpret_cast<const int4*>(&b_sh[2][q][4 * tx]);
            const int arv[4] = {ar.x, ar.y, ar.z, ar.w};
            const int aiv[4] = {ai.x, ai.y, ai.z, ai.w};
            const int adv[4] = {ad.x, ad.y, ad.z, ad.w};
            const int brv[4] = {br.x, br.y, br.z, br.w};
            const int biv[4] = {bi.x, bi.y, bi.z, bi.w};
            const int bsv[4] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    p1[m][n] = __dp4a(arv[m], brv[n], p1[m][n]);
                    p2[m][n] = __dp4a(aiv[m], biv[n], p2[m][n]);
                    p3[m][n] = __dp4a(adv[m], bsv[n], p3[m][n]);
                }
            }
        }
        __syncthreads();
    }

    const long long plane = static_cast<long long>(ninput) * ninput;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int i = i0 + 4 * ty + m;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            const int j = j0 + 4 * tx + n;
            if (i >= ninput || j >= ninput) continue;
            const long long o = c * plane + static_cast<long long>(i) * ninput + j;
            int vr = p1[m][n] + p2[m][n];
            int vi = p3[m][n] + p1[m][n] - p2[m][n];
            if (!fast_first) {
                vr += fast_r[o];
                vi += fast_i[o];
            }
            fast_r[o] = vr;
            fast_i[o] = vi;
            if (fast_last) {
                // slow receives a copy of fast, never an alias: the next
                // window overwrites fast in place
                if (!slow_first) {
                    vr += slow_r[o];
                    vi += slow_i[o];
                }
                slow_r[o] = vr;
                slow_i[o] = vi;
            }
        }
    }
}

}  // namespace

// packed: uint8 chan-major view, element (c, t, i) at
// c * stride_c + t * stride_t + i.  State planes: int32 [nchan, ninput,
// ninput], contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int cbd_corr_acc(const void* packed, long long stride_c,
                            long long stride_t, int nchan, int ntime,
                            int ninput, void* fast_r, void* fast_i,
                            void* slow_r, void* slow_i, int fast_first,
                            int fast_last, int slow_first, void* stream)
{
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(ntile * (ntile + 1) / 2, nchan);
    corr_acc_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, ntime,
        ninput, ntile, static_cast<int*>(fast_r), static_cast<int*>(fast_i),
        static_cast<int*>(slow_r), static_cast<int*>(slow_i), fast_first,
        fast_last, slow_first);
    return static_cast<int>(cudaGetLastError());
}
