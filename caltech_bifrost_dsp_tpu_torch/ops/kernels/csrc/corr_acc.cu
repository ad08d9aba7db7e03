// Correlator with the accumulator algebra fused in, on the int8 tensor
// cores of sm_90a.
//
// Replaces the TPU kernel caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py::
// packed_corr_blk_acc (256-block triangular int8 Karatsuba correlator).
//
// One block computes one channel's 128 x 128 tile pair (ti <= tj) of the
// visibility matrix over the whole time window, then applies the
// integration-boundary algebra in place on the state planes:
//
//     fast = gulp            if fast_first else fast + gulp
//     slow = unchanged       if not fast_last
//          = copy of fast    if slow_first
//          = slow + fast     otherwise
//
// Arithmetic: the int8 tensor-core tile of corr_tile.cuh (mma.sync.m16n8k32
// s8 -> s32, exact; operands as planes of 4-sample words at pitch 136;
// four real products into two fragment sets).  Karatsuba's third
// accumulator would take the warp tile from 128 to 192 registers per lane
// and a sixth staged plane; the tensor cores have the third more
// multiply-adds to spare, shared memory does not have the bandwidth (one
// 32-bit fragment load per MMA as it is).
//
// Tile: 8 warps, each a 64 x 32 piece of the 128 x 128 pair (4 x 4 MMA
// tiles, 2 x 64 accumulator registers a lane).  128-input tiles re-read
// each plane through L2 once per 21 pairs at 704 inputs, a third of what 64
// x 64 pairs took; 704 = 5.5 tiles, and warps whose rows or columns lie
// wholly past ninput skip their MMAs.  Time is staged 64 samples at a time
// in two buffers (85 KB of dynamic shared memory, one block per SM), so the
// loads of the next chunk overlap the MMAs of this one.
//
// Bound: at 704 inputs, 192 channels and 2400 spectra the call moves 0.32
// GB of samples and 1.5 GB of state (0.59 ms at the card's memory rate);
// its 4.8e11 multiply-adds on j >= i are 0.46 ms at the int8 tensor-core
// peak.  The contraction and the L2 traffic of the planes, not the state,
// set the pace: the unpack-once pair takes 3.9 ms on an H100 at 700 W.
//
// Contract: entries j >= i are valid (diagonal tiles are computed whole);
// entries in tiles below the diagonal are never written.  Time samples
// past ntime and inputs past ninput read as zero; pad lanes of a padded
// input axis are never read.
//
// Three launchers share the tile code (corr_acc_kernel<GULP, CACHED>):
//
// cbd_corr_acc unpacks its own tiles: each thread fetches the bytes of the
// next chunk into registers before the MMAs of this one and splits them
// into planes, four samples at a time with byte-parallel word arithmetic,
// after them.
//
// cbd_corr_acc_cached replaces corr_blk.py::_corr_blk_acc_cached
// (unpack_cache=True): a prepass unpacks the block ONCE into three planes
// (re, im, -re) and the contraction stages its tiles from those with
// 16-byte cp.async and no nibble arithmetic; same tile pairs, same
// epilogue, bit-identical state.  The TPU version caches in VMEM; one
// channel's planes at 704 inputs x 2400 spectra are 5.5 MB, which no SM's
// shared memory holds, so the cache is a per-call scratch in global memory
// [nchan][3][nq][pitch] (1.1 GB at 192 channels).  Blocks run pair
// fastest, channel slowest, so the few channels in flight at one time are
// served from the 50 MB L2.
//
// cbd_corr_blk replaces corr_blk.py::packed_corr_blk, the gulp correlator
// of the sharded programs: the same tile pairs from the same prepass
// planes, no epilogue.  It writes a fresh gulp into the upper tile pairs of
// two output planes and reads no state.  The TPU kernel pads the input axis
// to 256 and slices the result; this one masks ragged edges, so the padded
// variant has no counterpart.

#include "corr_tile.cuh"

namespace {

constexpr int TCHUNK = 64;          // time samples staged per buffer
constexpr int NQ = TCHUNK / 4;      // packed 4-sample words per input
constexpr int NSTAGED = 5;          // row re, im, -re; column re, im
constexpr int NCACHED = 3;          // prepass planes: re, im, -re
constexpr int STAGE = NSTAGED * NQ * PITCH;     // words per buffer
constexpr int SMEM_BYTES = 2 * STAGE * 4;
constexpr int NRAW = 2 * NQ * TILE / THREADS;   // fetched words per thread

// Four time samples t0 .. t0 + 3 of input ``in`` as one word, sample u in
// byte u; zero past ntime.
__device__ __forceinline__ unsigned fetch4(const uint8_t* __restrict__ base,
                                           long long stride_t, int ntime,
                                           int t0, int in)
{
    unsigned w = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        if (t0 + u < ntime) {
            w |= static_cast<unsigned>(
                     base[static_cast<long long>(t0 + u) * stride_t + in])
                 << (8 * u);
        }
    }
    return w;
}

// Words of one cached plane row (inputs padded to whole tiles) and rows of
// one cached plane (time padded to whole chunks).
__host__ __device__ __forceinline__ int cache_pitch(int ninput)
{
    return (ninput + TILE - 1) / TILE * TILE;
}
__host__ __device__ __forceinline__ int cache_nq(int ntime)
{
    return (ntime + TCHUNK - 1) / TCHUNK * NQ;
}

// Prepass of the cached variants: planes[c][p][q][in] for p = re, im, -re;
// samples past ntime and inputs past ninput are zero.
__global__ void __launch_bounds__(THREADS)
unpack_planes_kernel(const uint8_t* __restrict__ packed, long long stride_c,
                     long long stride_t, int ntime, int ninput, int nq_tot,
                     int pitch, int* __restrict__ planes)
{
    const int in = blockIdx.x * THREADS + threadIdx.x;
    if (in >= pitch) return;
    const int c = blockIdx.z;
    const uint8_t* base = packed + static_cast<long long>(c) * stride_c;
    const long long plane = static_cast<long long>(nq_tot) * pitch;
    int* pc = planes + NCACHED * plane * c;
    for (int qq = 0; qq < NQ; ++qq) {
        const int q = blockIdx.y * NQ + qq;
        unsigned re4 = 0, im4 = 0;
        if (in < ninput) {
            const unsigned w = fetch4(base, stride_t, ntime, 4 * q, in);
            re4 = sext4x4((w >> 4) & 0x0F0F0F0Fu);
            im4 = sext4x4(w & 0x0F0F0F0Fu);
        }
        const long long o = static_cast<long long>(q) * pitch + in;
        pc[o] = static_cast<int>(re4);
        pc[plane + o] = static_cast<int>(im4);
        pc[2 * plane + o] = static_cast<int>(neg4(re4));
    }
}

// GULP: write the fresh gulp to fast_r/fast_i and touch no state (the
// flags and slow planes are ignored).  CACHED: stage the tiles from the
// prepass planes instead of unpacking ``packed``.
template <bool GULP, bool CACHED>
__global__ void __launch_bounds__(THREADS, 1)
corr_acc_kernel(const uint8_t* __restrict__ packed, long long stride_c,
                long long stride_t, const int* __restrict__ planes,
                int ntime, int ninput, int ntile,
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

    // two buffers of [plane][word][input, pitch PITCH]
    extern __shared__ __align__(16) int stage_sh[];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wm = (tid >> 5) >> 2;     // rows wm * 64 ..
    const int wn = (tid >> 5) & 3;      // columns wn * 32 ..
    const bool active = i0 + wm * 64 < ninput && j0 + wn * 32 < ninput;

    Acc vr, vi;
    zero_acc(vr, vi);

    const uint8_t* base = packed + static_cast<long long>(c) * stride_c;
    const int pitch = cache_pitch(ninput);
    const long long cplane = static_cast<long long>(cache_nq(ntime)) * pitch;
    const int* pc = planes + NCACHED * cplane * c;
    const int nchunk = (ntime + TCHUNK - 1) / TCHUNK;

    // CACHED: 5 planes x NQ words x TILE / 4 vectors of 4 inputs, copied
    // asynchronously into ``buf``
    auto stage_cached = [&](int chunk, int* buf) {
        constexpr int NV = TILE / 4;
        for (int item = tid; item < NSTAGED * NQ * NV; item += THREADS) {
            const int pl = item / (NQ * NV);
            const int rem = item - pl * (NQ * NV);
            const int q = rem / NV;
            const int v = rem - q * NV;
            const int* src = pc + (pl < 3 ? pl : pl - 3) * cplane
                + static_cast<long long>(chunk * NQ + q) * pitch
                + (pl < 3 ? i0 : j0) + 4 * v;
            cp_async16(buf + (pl * NQ + q) * PITCH + 4 * v, src);
        }
        cp_async_commit();
    };
    // not CACHED: item = (side, word, input); the bytes of a chunk are
    // fetched into ``raw`` and split into planes later
    unsigned raw[NRAW];
    auto fetch_raw = [&](int chunk) {
#pragma unroll
        for (int it = 0; it < NRAW; ++it) {
            const int item = it * THREADS + tid;
            const int side = item / (NQ * TILE);
            const int rem = item - side * (NQ * TILE);
            const int q = rem / TILE;
            const int in = (side ? j0 : i0) + rem - q * TILE;
            raw[it] = in < ninput
                ? fetch4(base, stride_t, ntime, chunk * TCHUNK + 4 * q, in)
                : 0u;
        }
    };
    auto store_raw = [&](int* buf) {
#pragma unroll
        for (int it = 0; it < NRAW; ++it) {
            const int item = it * THREADS + tid;
            const int side = item / (NQ * TILE);
            const int rem = item - side * (NQ * TILE);
            const int q = rem / TILE;
            const int k = rem - q * TILE;
            const unsigned re4 = sext4x4((raw[it] >> 4) & 0x0F0F0F0Fu);
            const unsigned im4 = sext4x4(raw[it] & 0x0F0F0F0Fu);
            int* dst = buf + ((side ? 3 : 0) * NQ + q) * PITCH + k;
            dst[0] = static_cast<int>(re4);
            dst[NQ * PITCH] = static_cast<int>(im4);
            if (!side) {
                dst[2 * NQ * PITCH] = static_cast<int>(neg4(re4));
            }
        }
    };

    if (nchunk > 0) {
        if constexpr (CACHED) {
            stage_cached(0, stage_sh);
        } else {
            fetch_raw(0);
            store_raw(stage_sh);
        }
    }
    for (int chunk = 0; chunk < nchunk; ++chunk) {
        int* cur = stage_sh + (chunk & 1) * STAGE;
        int* nxt = stage_sh + ((chunk + 1) & 1) * STAGE;
        if constexpr (CACHED) {
            cp_async_wait_all();
        }
        // ``cur`` is complete for every thread, and every thread is done
        // with the MMAs of the previous chunk, which read ``nxt``
        __syncthreads();
        if (chunk + 1 < nchunk) {
            if constexpr (CACHED) {
                stage_cached(chunk + 1, nxt);
            } else {
                fetch_raw(chunk + 1);
            }
        }
        if (active) {
#pragma unroll
            for (int ks = 0; ks < TCHUNK / 32; ++ks) {
                const int* a = cur + ks * 8 * PITCH;
                mma_kstep<NEG_A>(a, NQ * PITCH, a + 3 * NQ * PITCH,
                                 NQ * PITCH, wm * 64, wn * 32, lane, vr, vi);
            }
        }
        if constexpr (!CACHED) {
            if (chunk + 1 < nchunk) {
                store_raw(nxt);
            }
        }
    }

    if (!active) return;
    const long long plane = static_cast<long long>(ninput) * ninput;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = i0 + wm * 64 + m * 16 + g + (e >> 1) * 8;
                const int j = j0 + wn * 32 + n * 8 + 2 * t + (e & 1);
                if (i >= ninput || j >= ninput) continue;
                const long long o = c * plane
                    + static_cast<long long>(i) * ninput + j;
                int r = vr[m][n][e];
                int s = vi[m][n][e];
                if (!GULP && !fast_first) {
                    r += fast_r[o];
                    s += fast_i[o];
                }
                fast_r[o] = r;
                fast_i[o] = s;
                if (!GULP && fast_last) {
                    // slow receives a copy of fast, never an alias: the
                    // next window overwrites fast in place
                    if (!slow_first) {
                        r += slow_r[o];
                        s += slow_i[o];
                    }
                    slow_r[o] = r;
                    slow_i[o] = s;
                }
            }
        }
    }
}

long long cache_nint(int nchan, int ntime, int ninput)
{
    return static_cast<long long>(NCACHED) * nchan * cache_nq(ntime)
        * cache_pitch(ninput);
}

cudaError_t unpack_planes(const void* packed, long long stride_c,
                          long long stride_t, int nchan, int ntime,
                          int ninput, void* scratch, cudaStream_t stream)
{
    const int pitch = cache_pitch(ninput);
    const int nq_tot = cache_nq(ntime);
    if (nq_tot == 0) {
        return cudaSuccess;
    }
    const dim3 grid((pitch + THREADS - 1) / THREADS, nq_tot / NQ, nchan);
    unpack_planes_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, ntime,
        ninput, nq_tot, pitch, static_cast<int*>(scratch));
    return cudaGetLastError();
}

template <bool GULP, bool CACHED>
cudaError_t contract(const void* packed, long long stride_c,
                     long long stride_t, const void* scratch, int nchan,
                     int ntime, int ninput, void* fast_r, void* fast_i,
                     void* slow_r, void* slow_i, int fast_first,
                     int fast_last, int slow_first, cudaStream_t stream)
{
    auto kernel = corr_acc_kernel<GULP, CACHED>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) {
        return err;
    }
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(ntile * (ntile + 1) / 2, nchan);
    kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t,
        static_cast<const int*>(scratch), ntime, ninput, ntile,
        static_cast<int*>(fast_r), static_cast<int*>(fast_i),
        static_cast<int*>(slow_r), static_cast<int*>(slow_i), fast_first,
        fast_last, slow_first);
    return cudaGetLastError();
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
    if (nchan <= 0 || ninput <= 0 || ntime < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(contract<false, false>(
        packed, stride_c, stride_t, nullptr, nchan, ntime, ninput, fast_r,
        fast_i, slow_r, slow_i, fast_first, fast_last, slow_first,
        static_cast<cudaStream_t>(stream)));
}

// cbd_corr_acc with the block unpacked once: ``scratch`` holds at least
// 3 * nchan * cache_nq(ntime) * cache_pitch(ninput) ints (``scratch_nint``
// is checked), 16-byte aligned.  Two launches on ``stream``: the prepass,
// then the contraction.
extern "C" int cbd_corr_acc_cached(const void* packed, long long stride_c,
                                   long long stride_t, int nchan, int ntime,
                                   int ninput, void* scratch,
                                   long long scratch_nint, void* fast_r,
                                   void* fast_i, void* slow_r, void* slow_i,
                                   int fast_first, int fast_last,
                                   int slow_first, void* stream)
{
    if (nchan <= 0 || ninput <= 0 || ntime < 0
            || scratch_nint < cache_nint(nchan, ntime, ninput)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = unpack_planes(packed, stride_c, stride_t, nchan,
                                          ntime, ninput, scratch, s);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(contract<false, true>(
        packed, stride_c, stride_t, scratch, nchan, ntime, ninput, fast_r,
        fast_i, slow_r, slow_i, fast_first, fast_last, slow_first, s));
}

// The gulp correlator: out planes int32 [nchan, ninput, ninput],
// contiguous; tile pairs with tile(j) >= tile(i) (128-input tiles) are
// written, the rest is never touched.  ``scratch`` as for
// cbd_corr_acc_cached: the prepass, then the contraction.
extern "C" int cbd_corr_blk(const void* packed, long long stride_c,
                            long long stride_t, int nchan, int ntime,
                            int ninput, void* scratch,
                            long long scratch_nint, void* out_r, void* out_i,
                            void* stream)
{
    if (nchan <= 0 || ninput <= 0 || ntime < 0
            || scratch_nint < cache_nint(nchan, ntime, ninput)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = unpack_planes(packed, stride_c, stride_t, nchan,
                                          ntime, ninput, scratch, s);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(contract<true, true>(
        packed, stride_c, stride_t, scratch, nchan, ntime, ninput, out_r,
        out_i, nullptr, nullptr, 1, 0, 0, s));
}
