// Row-resident gulp correlator, on the int8 tensor cores of sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/corr_rows.py::
// packed_corr_rows (grid over (channel, row tile); each instance unpacks
// its row tile once and streams the j >= i column tiles by double-buffered
// DMA).  No accumulation: one call writes the visibilities of one packed
// block,
//
//     vr[c, i, j] = sum_t ar_i br_j + ai_i bi_j
//     vi[c, i, j] = sum_t ai_i br_j - ar_i bi_j
//
// the function of corr_triu.cu on another schedule.
//
// Grid: one block per (channel, row tile of 128 inputs).  The block keeps
// its row operand RESIDENT in shared memory, unpacked once into the planes
// re, im of corr_tile.cuh, and walks the column tiles tj >= ti: the
// diagonal tile straight from the resident planes (-re made from the re
// fragment with neg4), every other one streamed in 64-sample chunks (two
// MMA k steps), each chunk's packed bytes fetched by cp.async into a ring
// of three raw stages and unpacked into re, im, -im in one of two column
// buffers while the MMAs of the previous chunk run; one barrier per chunk.
// 8 warps contract with mma.sync.m16n8k32, each a 64 x 32 piece.  So a
// channel costs npair tile fetches and unpacks (21 at 704 inputs) instead
// of corr_triu.cu's 2 * npair - ntile (36): a row tile is unpacked once per
// segment, not once per pair.
//
// What the card forces: a row tile over a whole 2400-spectra window is
// 128 x 2400 x 2 bytes = 0.6 MB unpacked, and a block has 227 KB of shared
// memory.  The row operand is therefore resident per time SEGMENT of TSEG
// = 512 samples, so that a 480-spectra gulp is one segment (2 x 128 words x
// 136 x 4 B = 139 KB, plus 52 KB of column buffers and 24 KB of raw ring;
// the negated plane sits on the column side because the resident side is
// what fills the shared memory), and the row strips accumulate across
// segments in the output planes: the first segment stores, the later ones
// add (only this block touches its strips, so there is no race).  Blocks
// launch channel fastest and row tile slowest, so every channel's row tile
// 0 (the most column tiles) starts before any row tile 1: the heaviest
// blocks first, and the light ones fill the last wave.
//
// Bound: as corr_triu.cu (4.8e11 multiply-adds on j >= i at 704 x 192 x
// 2400, 0.46 ms at the int8 tensor-core peak).  A call over several
// segments also reads back and rewrites its strips once per later segment
// (0.9 GB each at 704 x 192), which a call per gulp does not.
//
// Contract (that of corr_triu.cu): entries in 128-input tiles with
// tile(j) >= tile(i) are written, diagonal tiles whole; tiles below the
// diagonal are never written.  Time samples past ntime and inputs past
// ninput read as zero; pad lanes of a padded input axis are never read.

#include "corr_tile.cuh"

namespace {

constexpr int TCHUNK = 64;                  // samples per chunk
constexpr int NQ = TCHUNK / 4;              // words per input of a chunk
constexpr int TSEG = 512;                   // samples of the resident rows
constexpr int SQ = TSEG / 4;                // words per input of a segment
constexpr int RESIDENT = 2 * SQ * PITCH;    // row re, im
constexpr int COLBUF = 3 * NQ * PITCH;      // column re, im, -im of a chunk
constexpr int NSLOT = 3;                    // raw stages in the ring
constexpr int RAW_CHUNK = TCHUNK * RAW_ROW; // raw words of one chunk
constexpr int SMEM_BYTES = (RESIDENT + 2 * COLBUF + NSLOT * RAW_CHUNK) * 4;
static_assert(TSEG % TCHUNK == 0, "a segment is whole chunks");

__global__ void __launch_bounds__(THREADS, 1)
corr_rows_kernel(const uint8_t* __restrict__ packed, long long stride_c,
                 long long stride_t, int ntime, int ninput, int ntile,
                 int vec16, int* __restrict__ out_r, int* __restrict__ out_i)
{
    extern __shared__ __align__(16) int smem[];
    int* res = smem;                    // [2][SQ][PITCH]
    int* col = res + RESIDENT;          // two buffers of [3][NQ][PITCH]
    int* raw = col + 2 * COLBUF;        // NSLOT x [TCHUNK][RAW_ROW]

    const int c = blockIdx.x;
    const int ti = blockIdx.y;
    const int i0 = ti * TILE;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wm = (tid >> 5) >> 2;     // rows wm * 64 ..
    const int wn = (tid >> 5) & 3;      // columns wn * 32 ..
    const uint8_t* base = packed + static_cast<long long>(c) * stride_c;
    const long long plane = static_cast<long long>(ninput) * ninput;
    int* plane_r = out_r + c * plane;
    int* plane_i = out_i + c * plane;
    const int ncol = ntile - 1 - ti;    // column tiles past the diagonal

    Acc vr, vi;
    zero_acc(vr, vi);
    auto active = [&](int tj) {
        return i0 + wm * 64 < ninput && tj * TILE + wn * 32 < ninput;
    };
    auto store = [&](int tj, bool add) {
        store_piece(vr, vi, plane_r, plane_i, i0 + wm * 64,
                    tj * TILE + wn * 32, ninput, lane, add);
        zero_acc(vr, vi);
    };

    for (int seg0 = 0; seg0 < ntime; seg0 += TSEG) {
        const int seg_len = ntime - seg0 < TSEG ? ntime - seg0 : TSEG;
        const int nch = (seg_len + TCHUNK - 1) / TCHUNK;
        const int nks = (seg_len + 31) / 32;    // k steps with samples
        // job k: chunk k % nch of tile ti + k / nch; the nch jobs of the
        // row tile go to the resident planes, the rest to column buffers
        const int njob = nch * (1 + ncol);
        auto fetch = [&](int k) {
            if (k < njob) {
                const int t0 = seg0 + (k % nch) * TCHUNK;
                const int in0 = (ti + k / nch) * TILE;
                stage_raw<TCHUNK>(raw + (k % NSLOT) * RAW_CHUNK,
                                  base + t0 * stride_t + in0, stride_t,
                                  ntime - t0, ninput - in0, vec16, tid);
            }
            cp_async_commit();
        };
        auto unpack = [&](int k) {
            const int* r = raw + (k % NSLOT) * RAW_CHUNK;
            if (k < nch) {
                unpack_raw<TCHUNK, RE_IM>(r, res + k * NQ * PITCH,
                                          SQ * PITCH, tid);
            } else {
                unpack_raw<TCHUNK, RE_IM_NIM>(r, col + (k & 1) * COLBUF,
                                              NQ * PITCH, tid);
            }
        };

        // every thread is done with the previous segment's buffers
        __syncthreads();
        for (int k = 0; k < NSLOT; ++k) {
            fetch(k);
        }
        cp_async_wait_but<NSLOT - 1>();     // job 0
        __syncthreads();
        unpack(0);
        for (int k = 0; k < njob; ++k) {
            cp_async_wait_but<NSLOT - 2>();     // job k + 1
            // job k is unpacked and job k + 1 has landed for every thread;
            // every thread is done with the MMAs of job k - 1, which read
            // the column buffer job k + 1 goes to, and with job k's slot
            __syncthreads();
            fetch(k + NSLOT);
            const int ch = k % nch;
            if (k >= nch) {
                const int tj = ti + k / nch;
                if (active(tj)) {
#pragma unroll
                    for (int ks = 0; ks < TCHUNK / 32; ++ks) {
                        // the last chunk of a gulp may hold one k step
                        if (ch * (TCHUNK / 32) + ks < nks) {
                            mma_kstep<NEG_B>(
                                res + (ch * NQ + ks * 8) * PITCH, SQ * PITCH,
                                col + (k & 1) * COLBUF + ks * 8 * PITCH,
                                NQ * PITCH, wm * 64, wn * 32, lane, vr, vi);
                        }
                    }
                }
                if (ch == nch - 1) {
                    store(tj, seg0 > 0);
                }
            } else if (ch == nch - 1) {
                // the resident planes are complete: the diagonal tile
                if (active(ti)) {
                    for (int q = 0; q < nks * 8; q += 8) {
                        const int* a = res + q * PITCH;
                        mma_kstep<NEG_A_ALU>(a, SQ * PITCH, a, SQ * PITCH,
                                             wm * 64, wn * 32, lane, vr, vi);
                    }
                }
                store(ti, seg0 > 0);
            }
            if (k + 1 < njob) {
                unpack(k + 1);
            }
        }
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
    const int vec16 = ((reinterpret_cast<uintptr_t>(packed) | stride_c
                        | stride_t) & 15) == 0;
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(nchan, ntile);
    corr_rows_kernel<<<grid, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, ntime,
        ninput, ntile, vec16, static_cast<int*>(out_r),
        static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
}
