// Row-streamed gulp correlator, for sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/corr_rows.py::
// packed_corr_rows (grid over (channel, row tile); each instance unpacks
// its row tile once and streams the j >= i column tiles).  No accumulation:
// one call writes the visibilities of one packed block,
//
//     vr[c, i, j] = sum_t ar_i br_j + ai_i bi_j
//     vi[c, i, j] = sum_t ai_i br_j - ar_i bi_j
//
// the function of corr_triu.cu on another schedule.
//
// Grid: one block per (row tile of 128 inputs, channel).  The block keeps
// its row operand RESIDENT in shared memory, already unpacked to signed
// bytes packed four time samples to an int (planes re, im, -re), and walks
// the column tiles tj >= ti; per column tile it stages TCHUNK time samples
// of the column operand at a time (planes re, im) and contracts with
// __dp4a on an 8 x 8 register sub-tile per thread, as corr_triu.cu does.
// So a row tile is unpacked once per row, not once per tile pair, and a
// channel costs ntile + npair tile fetches (27 at 704 inputs) instead of
// 2 * npair (42).
//
// What the card forces: a row tile over a whole 2400-spectra window is
// 128 x 2400 x 3 bytes = 0.9 MB unpacked, and a block has 227 KB of shared
// memory.  The row operand is therefore resident per time SEGMENT of TSEG
// = 512 samples (3 x 128 x 512 = 192 KB, plus 8 KB for the column chunk),
// and the row strips accumulate across segments in the output planes: the
// first segment stores, the later ones add (only this block touches its
// strips, so there is no race).  At 2400 spectra that is 5 passes over the
// 0.45 GB of upper strips, about 4 GB of traffic beside 1.6e11 dp4a, so
// the kernel stays bound by integer issue rate.
//
// Exactness: int32 sums, |partial| <= 2 * 64 * T.
//
// Contract (that of corr_triu.cu): entries in 128-input tiles with
// tile(j) >= tile(i) are written, diagonal tiles whole; tiles below the
// diagonal are never written.  Time samples past ntime and inputs past
// ninput read as zero; pad lanes of a padded input axis are never read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;           // inputs per tile side
constexpr int TCHUNK = 32;          // column samples staged per iteration
constexpr int NQ = TCHUNK / 4;      // packed 4-sample words per chunk
constexpr int TSEG = 512;           // samples of the resident row operand
constexpr int SQ = TSEG / 4;        // words per input of a resident plane
constexpr int THREADS = 256;        // 16 x 16 threads, 8 x 8 outputs each
constexpr int SMEM_BYTES = (3 * SQ + 2 * NQ) * TILE * 4;

__device__ __forceinline__ int sext4(unsigned v) {
    return static_cast<int>(v ^ 8u) - 8;
}

__global__ void __launch_bounds__(THREADS)
corr_rows_kernel(const uint8_t* __restrict__ packed, long long stride_c,
                 long long stride_t, int ntime, int ninput, int ntile,
                 int* __restrict__ out_r, int* __restrict__ out_i)
{
    extern __shared__ int4 smem4[];
    int* a_res = reinterpret_cast<int*>(smem4);   // [3][SQ][TILE] re, im, -re
    int* b_sh = a_res + 3 * SQ * TILE;            // [2][NQ][TILE] re, im

    const int ti = blockIdx.x;
    const int c = blockIdx.y;
    const int i0 = ti * TILE;
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const uint8_t* base = packed + static_cast<long long>(c) * stride_c;
    const long long plane = static_cast<long long>(ninput) * ninput;

    for (int seg0 = 0; seg0 < ntime; seg0 += TSEG) {
        const int seg_len = ntime - seg0 < TSEG ? ntime - seg0 : TSEG;
        const int nchunk = (seg_len + TCHUNK - 1) / TCHUNK;

        // the row operand of this segment, unpacked once
        for (int item = tid; item < nchunk * NQ * TILE; item += THREADS) {
            const int q = item / TILE;
            const int k = item - q * TILE;
            const int in = i0 + k;
            unsigned re4 = 0, im4 = 0, nr4 = 0;
            if (in < ninput) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int t = seg0 + 4 * q + u;
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
            a_res[(0 * SQ + q) * TILE + k] = static_cast<int>(re4);
            a_res[(1 * SQ + q) * TILE + k] = static_cast<int>(im4);
            a_res[(2 * SQ + q) * TILE + k] = static_cast<int>(nr4);
        }
        __syncthreads();

        for (int tj = ti; tj < ntile; ++tj) {
            const int j0 = tj * TILE;
            int acc_r[8][8], acc_i[8][8];
#pragma unroll
            for (int m = 0; m < 8; ++m) {
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    acc_r[m][n] = 0;
                    acc_i[m][n] = 0;
                }
            }

            for (int ch = 0; ch < nchunk; ++ch) {
                // this chunk of the column operand
                for (int item = tid; item < NQ * TILE; item += THREADS) {
                    const int q = item / TILE;
                    const int k = item - q * TILE;
                    const int in = j0 + k;
                    unsigned re4 = 0, im4 = 0;
                    if (in < ninput) {
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            const int t = seg0 + ch * TCHUNK + 4 * q + u;
                            if (t < ntime) {
                                const unsigned b = base[
                                    static_cast<long long>(t) * stride_t + in];
                                re4 |= (static_cast<unsigned>(sext4(b >> 4))
                                        & 0xFFu) << (8 * u);
                                im4 |= (static_cast<unsigned>(sext4(b & 15u))
                                        & 0xFFu) << (8 * u);
                            }
                        }
                    }
                    b_sh[q * TILE + k] = static_cast<int>(re4);
                    b_sh[(NQ + q) * TILE + k] = static_cast<int>(im4);
                }
                __syncthreads();

#pragma unroll 1
                for (int q = 0; q < NQ; ++q) {
                    const int qa = ch * NQ + q;
                    int ar[8], ai[8], an[8], br[8], bi[8];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int ra = 64 * h + 4 * ty;
                        const int rb = 64 * h + 4 * tx;
                        const int4 vr = *reinterpret_cast<const int4*>(
                            &a_res[(0 * SQ + qa) * TILE + ra]);
                        const int4 vi = *reinterpret_cast<const int4*>(
                            &a_res[(1 * SQ + qa) * TILE + ra]);
                        const int4 vn = *reinterpret_cast<const int4*>(
                            &a_res[(2 * SQ + qa) * TILE + ra]);
                        const int4 wr = *reinterpret_cast<const int4*>(
                            &b_sh[q * TILE + rb]);
                        const int4 wi = *reinterpret_cast<const int4*>(
                            &b_sh[(NQ + q) * TILE + rb]);
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

            // the strip of this column tile: stored by the first segment,
            // added to by the later ones
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const int i = i0 + 64 * (m >> 2) + 4 * ty + (m & 3);
                if (i >= ninput) continue;
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    const int j = j0 + 64 * (n >> 2) + 4 * tx + (n & 3);
                    if (j >= ninput) continue;
                    const long long o = c * plane
                        + static_cast<long long>(i) * ninput + j;
                    if (seg0 == 0) {
                        out_r[o] = acc_r[m][n];
                        out_i[o] = acc_i[m][n];
                    } else {
                        out_r[o] += acc_r[m][n];
                        out_i[o] += acc_i[m][n];
                    }
                }
            }
        }
        // every read of a_res is behind the chunk loop's last barrier
    }
}

}  // namespace

// packed: uint8 chan-major view, element (c, t, i) at
// c * stride_c + t * stride_t + i.  Output planes: int32 [nchan, ninput,
// ninput], contiguous.  Returns the first CUDA error of the set-up or the
// launch.
extern "C" int cbd_corr_rows(const void* packed, long long stride_c,
                             long long stride_t, int nchan, int ntime,
                             int ninput, void* out_r, void* out_i,
                             void* stream)
{
    if (nchan <= 0 || ninput <= 0 || ntime < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaFuncSetAttribute(
        corr_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(ntile, nchan);
    corr_rows_kernel<<<grid, THREADS, SMEM_BYTES,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, ntime,
        ninput, ntile, static_cast<int*>(out_r), static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
}
