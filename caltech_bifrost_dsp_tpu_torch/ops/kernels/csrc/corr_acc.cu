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
//
// Two more launchers share the tile contraction:
//
// cbd_corr_blk replaces corr_blk.py::packed_corr_blk, the gulp correlator
// of the sharded programs: the same tile pairs, no epilogue.  It writes a
// fresh gulp into the upper tile pairs of two output planes and reads no
// state.  The TPU kernel pads the input axis to 256 and slices the result;
// this one masks ragged edges, so the padded variant has no counterpart.
//
// cbd_corr_acc_cached replaces corr_blk.py::_corr_blk_acc_cached
// (unpack_cache=True): a prepass unpacks the block ONCE into four planes
// of sign-extended bytes, four time samples to an int (re, im, im - re,
// re + im), and the contraction stages its tiles from those planes with
// 16-byte loads and no nibble arithmetic in its loop; same tile pairs,
// same epilogue, bit-identical state.  The TPU version caches in VMEM; one
// channel's planes at 704 inputs x 2400 spectra are 6.8 MB, which no SM's
// shared memory holds, so the cache is a per-call scratch in global memory
// [nchan][4][nq][pitch] (1.3 GB at 192 channels).  Blocks are issued pair
// fastest, channel slowest, so the few channels in flight at one time
// (a few times 6.8 MB) are served from the 50 MB L2.

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

// Words of one cached plane row (inputs padded to whole tiles) and rows of
// one cached plane (time padded to whole chunks).
__host__ __device__ __forceinline__ int cache_pitch(int ninput) {
    return (ninput + TILE - 1) / TILE * TILE;
}
__host__ __device__ __forceinline__ int cache_nq(int ntime) {
    return (ntime + TCHUNK - 1) / TCHUNK * NQ;
}

// Prepass of the cached variant: planes[c][p][q][in] for p = re, im,
// im - re, re + im; samples past ntime and inputs past ninput are zero.
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
    int* pc = planes + 4 * plane * c;
    for (int qq = 0; qq < NQ; ++qq) {
        const int q = blockIdx.y * NQ + qq;
        unsigned re4 = 0, im4 = 0, df4 = 0, sm4 = 0;
        if (in < ninput) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int t = 4 * q + u;
                int re = 0, im = 0;
                if (t < ntime) {
                    const unsigned b = base[static_cast<long long>(t)
                                            * stride_t + in];
                    re = sext4(b >> 4);
                    im = sext4(b & 15u);
                }
                re4 |= (static_cast<unsigned>(re) & 0xFFu) << (8 * u);
                im4 |= (static_cast<unsigned>(im) & 0xFFu) << (8 * u);
                df4 |= (static_cast<unsigned>(im - re) & 0xFFu) << (8 * u);
                sm4 |= (static_cast<unsigned>(re + im) & 0xFFu) << (8 * u);
            }
        }
        const long long o = static_cast<long long>(q) * pitch + in;
        pc[o] = static_cast<int>(re4);
        pc[plane + o] = static_cast<int>(im4);
        pc[2 * plane + o] = static_cast<int>(df4);
        pc[3 * plane + o] = static_cast<int>(sm4);
    }
}

// GULP: write the fresh gulp to fast_r/fast_i and touch no state (the
// flags and slow planes are ignored).  CACHED: stage the tiles from the
// prepass planes instead of unpacking ``packed``.
template <bool GULP, bool CACHED>
__global__ void __launch_bounds__(THREADS)
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

    const int pitch = cache_pitch(ninput);
    const long long cplane = static_cast<long long>(cache_nq(ntime)) * pitch;

    for (int t0 = 0; t0 < ntime; t0 += TCHUNK) {
        if constexpr (CACHED) {
            // 2 sides x 3 planes x NQ words x TILE / 4 vectors of 4 inputs
            constexpr int NV = TILE / 4;
            const int* pc = planes + 4 * cplane * c;
            for (int item = tid; item < 2 * 3 * NQ * NV; item += THREADS) {
                const int side = item / (3 * NQ * NV);
                int rem = item - side * (3 * NQ * NV);
                const int pl = rem / (NQ * NV);
                rem -= pl * (NQ * NV);
                const int q = rem / NV;
                const int v = rem - q * NV;
                const int src = pl < 2 ? pl : (side ? 3 : 2);
                const int4 val = *reinterpret_cast<const int4*>(
                    pc + src * cplane
                    + static_cast<long long>(t0 / 4 + q) * pitch
                    + (side ? j0 : i0) + 4 * v);
                int* dst = side ? &b_sh[pl][q][4 * v]
                                : &a_sh[pl][q][4 * v];
                *reinterpret_cast<int4*>(dst) = val;
            }
        } else {
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
            if (!GULP && !fast_first) {
                vr += fast_r[o];
                vi += fast_i[o];
            }
            fast_r[o] = vr;
            fast_i[o] = vi;
            if (!GULP && fast_last) {
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
    corr_acc_kernel<false, false><<<grid, THREADS, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, nullptr,
        ntime, ninput, ntile, static_cast<int*>(fast_r),
        static_cast<int*>(fast_i), static_cast<int*>(slow_r),
        static_cast<int*>(slow_i), fast_first, fast_last, slow_first);
    return static_cast<int>(cudaGetLastError());
}

// The gulp correlator: out planes int32 [nchan, ninput, ninput],
// contiguous; tile pairs with tile(j) >= tile(i) (64-input tiles) are
// written, the rest is never touched.
extern "C" int cbd_corr_blk(const void* packed, long long stride_c,
                            long long stride_t, int nchan, int ntime,
                            int ninput, void* out_r, void* out_i,
                            void* stream)
{
    if (nchan <= 0 || ninput <= 0 || ntime < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(ntile * (ntile + 1) / 2, nchan);
    corr_acc_kernel<true, false><<<grid, THREADS, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t, nullptr,
        ntime, ninput, ntile, static_cast<int*>(out_r),
        static_cast<int*>(out_i), nullptr, nullptr, 1, 0, 0);
    return static_cast<int>(cudaGetLastError());
}

// cbd_corr_acc with the block unpacked once: ``scratch`` holds at least
// 4 * nchan * cache_nq(ntime) * cache_pitch(ninput) ints (``scratch_nint``
// is checked), 16-byte aligned.  Two launches on ``stream``: the prepass, then the contraction.
extern "C" int cbd_corr_acc_cached(const void* packed, long long stride_c,
                                   long long stride_t, int nchan, int ntime,
                                   int ninput, void* scratch,
                                   long long scratch_nint, void* fast_r,
                                   void* fast_i, void* slow_r, void* slow_i,
                                   int fast_first, int fast_last,
                                   int slow_first, void* stream)
{
    if (nchan <= 0 || ninput <= 0 || ntime < 0
            || scratch_nint < 4LL * nchan * cache_nq(ntime)
                              * cache_pitch(ninput)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int pitch = cache_pitch(ninput);
    const int nq_tot = cache_nq(ntime);
    if (nq_tot > 0) {
        const dim3 pgrid((pitch + THREADS - 1) / THREADS, nq_tot / NQ, nchan);
        unpack_planes_kernel<<<pgrid, THREADS, 0,
            static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(packed), stride_c, stride_t, ntime,
            ninput, nq_tot, pitch, static_cast<int*>(scratch));
        const int err = static_cast<int>(cudaGetLastError());
        if (err != 0) return err;
    }
    const int ntile = (ninput + TILE - 1) / TILE;
    const dim3 grid(ntile * (ntile + 1) / 2, nchan);
    corr_acc_kernel<false, true><<<grid, THREADS, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), stride_c, stride_t,
        static_cast<const int*>(scratch), ntime, ninput, ntile,
        static_cast<int*>(fast_r), static_cast<int*>(fast_i),
        static_cast<int*>(slow_r), static_cast<int*>(slow_i), fast_first,
        fast_last, slow_first);
    return static_cast<int>(cudaGetLastError());
}
