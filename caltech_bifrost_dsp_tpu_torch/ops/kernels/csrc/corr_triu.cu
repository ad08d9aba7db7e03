// Gulp correlator over the upper 128 x 128 input-tile pairs, on the int8
// tensor cores of sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/corr_triu.py::
// packed_corr_triu (fused unpack + MXU dots over the j >= i tile pairs).
// No accumulation: one call writes the visibilities of one packed block,
//
//     vr[c, i, j] = sum_t ar_i br_j + ai_i bi_j
//     vi[c, i, j] = sum_t ai_i br_j - ar_i bi_j
//
// with a = input i, b = input j of channel c and the 4-bit parts sign
// extended.  The caller applies the accumulator algebra.
//
// Grid: one block per (upper tile pair, channel), the TPU kernel's grid,
// pair fastest so the few channels in flight are served from L2.  Like the
// TPU kernel it keeps no unpacked copy of the block in device memory: each
// block unpacks its own two tiles in shared memory.  Per 64-sample chunk,
// the packed bytes of both tiles (16 inputs of one time sample to a
// cp.async) go into a ring of three raw stages, so two chunks are in
// flight while a third is used; the block splits a landed chunk into
// planes (corr_tile.cuh: __byte_perm transpose, sext4x4, neg4) in two
// staged buffers, and 8 warps contract the other buffer with
// mma.sync.m16n8k32, each a 64 x 32 piece of the pair.  One barrier per
// chunk.  A diagonal pair stages its one tile once and reads it as both
// operands.  Strides that are not 16-byte aligned (tci with an input count
// that is no multiple of 16) and a tile edge that cuts a 16-input vector
// take byte loads inside the same kernel.
//
// Bound: at 704 inputs (6 tiles, 21 pairs, the last tile half empty), 192
// channels and 2400 spectra a call is 4.8e11 multiply-adds on j >= i
// (0.46 ms at the int8 tensor-core peak) and moves 0.32 GB of samples and
// 0.45 GB of upper tiles (0.23 ms).  What paces it is the issue rate of the
// MMA loop beside the unpack, each block unpacking its tiles on its own
// (a tile 6 times per channel at 704 inputs).
//
// Contract: entries in tiles with tile(j) >= tile(i) are written (diagonal
// tiles whole); tiles below the diagonal are never written.  Time samples
// past ntime and inputs past ninput read as zero; pad lanes of a padded
// input axis are never read.

#include "corr_tile.cuh"

namespace {

constexpr int TCHUNK = 64;                  // time samples per chunk
constexpr int NQ = TCHUNK / 4;              // words per input of a chunk
constexpr int STAGE = 5 * NQ * PITCH;       // row re, im, -re; column re, im
constexpr int NSLOT = 3;                    // raw stages in the ring
constexpr int RAW_SIDE = TCHUNK * RAW_ROW;  // raw words of one tile's chunk
constexpr int SMEM_BYTES = (2 * STAGE + NSLOT * 2 * RAW_SIDE) * 4;

__global__ void __launch_bounds__(THREADS, 1)
corr_triu_kernel(const uint8_t* __restrict__ packed, long long stride_c,
                 long long stride_t, int ntime, int ninput, int ntile,
                 int vec16, int* __restrict__ out_r, int* __restrict__ out_i)
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
    const bool diag = ti == tj;

    // two staged buffers of [plane][word][input], then the raw ring of
    // [tile][time][word]
    extern __shared__ __align__(16) int smem[];
    int* stage = smem;
    int* raw = smem + 2 * STAGE;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wm = (tid >> 5) >> 2;     // rows wm * 64 ..
    const int wn = (tid >> 5) & 3;      // columns wn * 32 ..
    const bool active = i0 + wm * 64 < ninput && j0 + wn * 32 < ninput;

    Acc vr, vi;
    zero_acc(vr, vi);

    const uint8_t* base = packed + static_cast<long long>(c) * stride_c;
    const int nchunk = (ntime + TCHUNK - 1) / TCHUNK;

    // one group per chunk (empty past the last), so the counts of
    // cp_async_wait_but hold to the end
    auto fetch = [&](int k) {
        if (k < nchunk) {
            int* r = raw + (k % NSLOT) * 2 * RAW_SIDE;
            const int t0 = k * TCHUNK;
            const uint8_t* src = base + t0 * stride_t;
            stage_raw<TCHUNK>(r, src + i0, stride_t, ntime - t0, ninput - i0,
                              vec16, tid);
            if (!diag) {
                stage_raw<TCHUNK>(r + RAW_SIDE, src + j0, stride_t,
                                  ntime - t0, ninput - j0, vec16, tid);
            }
        }
        cp_async_commit();
    };
    auto unpack = [&](int k) {
        const int* r = raw + (k % NSLOT) * 2 * RAW_SIDE;
        int* s = stage + (k & 1) * STAGE;
        unpack_raw<TCHUNK, RE_IM_NRE>(r, s, NQ * PITCH, tid);
        if (!diag) {
            unpack_raw<TCHUNK, RE_IM>(r + RAW_SIDE, s + 3 * NQ * PITCH,
                                      NQ * PITCH, tid);
        }
    };

    for (int k = 0; k < NSLOT; ++k) {
        fetch(k);
    }
    if (nchunk > 0) {
        cp_async_wait_but<NSLOT - 1>();     // chunk 0
        __syncthreads();
        unpack(0);
    }
    for (int k = 0; k < nchunk; ++k) {
        cp_async_wait_but<NSLOT - 2>();     // chunk k + 1
        // chunk k is unpacked and chunk k + 1 has landed for every thread;
        // every thread is done with the MMAs of chunk k - 1, which read the
        // buffer chunk k + 1 goes to, and with the raw slot of chunk k
        __syncthreads();
        fetch(k + NSLOT);
        const int* s = stage + (k & 1) * STAGE;
        if (active) {
#pragma unroll
            for (int ks = 0; ks < TCHUNK / 32; ++ks) {
                const int* a = s + ks * 8 * PITCH;
                mma_kstep<NEG_A>(a, NQ * PITCH,
                                 diag ? a : a + 3 * NQ * PITCH, NQ * PITCH,
                                 wm * 64, wn * 32, lane, vr, vi);
            }
        }
        if (k + 1 < nchunk) {
            unpack(k + 1);
        }
    }

    const long long plane = static_cast<long long>(ninput) * ninput;
    store_piece(vr, vi, out_r + c * plane, out_i + c * plane, i0 + wm * 64,
                j0 + wn * 32, ninput, lane, false);
}

}  // namespace

// packed: uint8 chan-major view, element (c, t, i) at
// c * stride_c + t * stride_t + i.  Output planes: int32 [nchan, ninput,
// ninput], contiguous.  Returns the first CUDA error of the set-up or the
// launch.
extern "C" int cbd_corr_triu(const void* packed, long long stride_c,
                             long long stride_t, int nchan, int ntime,
                             int ninput, void* out_r, void* out_i,
                             void* stream)
{
    if (nchan <= 0 || ninput <= 0 || ntime < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaFuncSetAttribute(
        corr_triu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const int vec16 = ((reinterpret_cast<uintptr_t>(packed) | stride_c
                        | stride_t) & 15) == 0;
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(ntile * (ntile + 1) / 2, nchan);
    corr_triu_kernel<<<grid, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, ntime,
        ninput, ntile, vec16, static_cast<int*>(out_r),
        static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
}
