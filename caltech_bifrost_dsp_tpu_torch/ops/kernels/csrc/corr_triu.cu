// Gulp correlator over the upper 128 x 128 input-tile pairs, for sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/corr_triu.py::
// packed_corr_triu (fused unpack + bf16 MXU dots over the j >= i tile
// pairs).  No accumulation: one call writes the visibilities of one packed
// block,
//
//     vr[c, i, j] = sum_t ar_i br_j + ai_i bi_j
//     vi[c, i, j] = sum_t ai_i br_j - ar_i bi_j
//
// with a = input i, b = input j of channel c and the 4-bit parts sign
// extended.  The caller applies the accumulator algebra.
//
// Grid: one block per (upper tile pair, channel), the TPU kernel's grid.
// Each block stages TCHUNK time samples of its two tiles in shared memory,
// unpacked to signed bytes packed four time samples to an int (row side:
// re, im, -re; column side: re, im), so one __dp4a contracts four samples.
// 256 threads each own an 8 x 8 register sub-tile (rows 4*ty + {0..3} and
// 64 + 4*ty + {0..3}, columns likewise with tx), read as 16-byte shared
// vectors: 40 shared loads feed 256 dp4a per four samples.
//
// Bound: at 704 inputs (6 tiles, 21 pairs, the last tile half empty), 192
// channels and 2400 spectra a call is 1.6e11 dp4a, so the kernel is bound
// by integer issue rate; the ~0.45 GB it writes to the upper tiles of the
// int32 planes is a few percent of that time.  Tensor-core int8 MMA is the
// later step.
//
// Exactness: |partial| <= 2 * 64 * T, far below 2^31.
//
// Contract: entries in tiles with tile(j) >= tile(i) are written (diagonal
// tiles whole); tiles below the diagonal are never written.  Time samples
// past ntime and inputs past ninput read as zero; pad lanes of a padded
// input axis are never read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;           // inputs per tile side
constexpr int TCHUNK = 32;          // time samples staged per iteration
constexpr int NQ = TCHUNK / 4;      // packed 4-sample words per input
constexpr int THREADS = 256;        // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ int sext4(unsigned v) {
    return static_cast<int>(v ^ 8u) - 8;
}

__global__ void __launch_bounds__(THREADS)
corr_triu_kernel(const uint8_t* __restrict__ packed, long long stride_c,
                 long long stride_t, int ntime, int ninput, int ntile,
                 int* __restrict__ out_r, int* __restrict__ out_i)
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

    // [plane][word][input]
    __shared__ __align__(16) int a_sh[3][NQ][TILE];   // re, im, -re
    __shared__ __align__(16) int b_sh[2][NQ][TILE];   // re, im

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;

    int acc_r[8][8], acc_i[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            acc_r[m][n] = 0;
            acc_i[m][n] = 0;
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
            unsigned re4 = 0, im4 = 0, nr4 = 0;
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
                    re4 |= (static_cast<unsigned>(re) & 0xFFu) << (8 * u);
                    im4 |= (static_cast<unsigned>(im) & 0xFFu) << (8 * u);
                    nr4 |= (static_cast<unsigned>(-re) & 0xFFu) << (8 * u);
                }
            }
            if (side) {
                b_sh[0][q][k] = static_cast<int>(re4);
                b_sh[1][q][k] = static_cast<int>(im4);
            } else {
                a_sh[0][q][k] = static_cast<int>(re4);
                a_sh[1][q][k] = static_cast<int>(im4);
                a_sh[2][q][k] = static_cast<int>(nr4);
            }
        }
        __syncthreads();

#pragma unroll 1
        for (int q = 0; q < NQ; ++q) {
            int ar[8], ai[8], an[8], br[8], bi[8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int ra = 64 * h + 4 * ty;
                const int rb = 64 * h + 4 * tx;
                const int4 vr = *reinterpret_cast<const int4*>(&a_sh[0][q][ra]);
                const int4 vi = *reinterpret_cast<const int4*>(&a_sh[1][q][ra]);
                const int4 vn = *reinterpret_cast<const int4*>(&a_sh[2][q][ra]);
                const int4 wr = *reinterpret_cast<const int4*>(&b_sh[0][q][rb]);
                const int4 wi = *reinterpret_cast<const int4*>(&b_sh[1][q][rb]);
                ar[4 * h] = vr.x; ar[4 * h + 1] = vr.y;
                ar[4 * h + 2] = vr.z; ar[4 * h + 3] = vr.w;
                ai[4 * h] = vi.x; ai[4 * h + 1] = vi.y;
                ai[4 * h + 2] = vi.z; ai[4 * h + 3] = vi.w;
                an[4 * h] = vn.x; an[4 * h + 1] = vn.y;
                an[4 * h + 2] = vn.z; an[4 * h + 3] = vn.w;
                br[4 * h] = wr.x; br[4 * h + 1] = wr.y;
                br[4 * h + 2] = wr.z; br[4 * h + 3] = wr.w;
                bi[4 * h] = wi.x; bi[4 * h + 1] = wi.y;
                bi[4 * h + 2] = wi.z; bi[4 * h + 3] = wi.w;
            }
#pragma unroll
            for (int m = 0; m < 8; ++m) {
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    acc_r[m][n] = __dp4a(ar[m], br[n], acc_r[m][n]);
                    acc_r[m][n] = __dp4a(ai[m], bi[n], acc_r[m][n]);
                    acc_i[m][n] = __dp4a(ai[m], br[n], acc_i[m][n]);
                    acc_i[m][n] = __dp4a(an[m], bi[n], acc_i[m][n]);
                }
            }
        }
        __syncthreads();
    }

    const long long plane = static_cast<long long>(ninput) * ninput;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
        const int i = i0 + 64 * (m >> 2) + 4 * ty + (m & 3);
        if (i >= ninput) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const int j = j0 + 64 * (n >> 2) + 4 * tx + (n & 3);
            if (j >= ninput) continue;
            const long long o = c * plane + static_cast<long long>(i) * ninput + j;
            out_r[o] = acc_r[m][n];
            out_i[o] = acc_i[m][n];
        }
    }
}

}  // namespace

// packed: uint8 chan-major view, element (c, t, i) at
// c * stride_c + t * stride_t + i.  Output planes: int32 [nchan, ninput,
// ninput], contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int cbd_corr_triu(const void* packed, long long stride_c,
                             long long stride_t, int nchan, int ntime,
                             int ninput, void* out_r, void* out_i,
                             void* stream)
{
    if (nchan <= 0 || ninput <= 0 || ntime < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(ntile * (ntile + 1) / 2, nchan);
    corr_triu_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, ntime,
        ninput, ntile, static_cast<int*>(out_r), static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
}
