// Baseline subselection gather with channel sum, for sm_90a.
//
// Replaces the TPU kernels caltech_bifrost_dsp_tpu/ops/pallas/
// subsel_gather.py::block_extract and ::band_extract together with the
// XLA take/sign/channel-sum around them (ops/corr_subsel.py::
// corr_subsel_bands).  The TPU slabs exist only to shrink XLA's gather
// operand; here the function is ported directly:
//
//     out[c', v] = sign_v * sum_{c in group(c')} M[c, lo_v, hi_v]
//
// read straight from the upper-valid accumulators, with both inputs of a
// pair clamped to [0, ninput - 1] before lo, hi and the sign are taken
// (xengine.py:94-99 and corr_subsel.py:83-91).
//
// Bound: bytes, and with them the loads in flight.  At 4705 baselines and
// 192 channels summed by 4 the call reads 2 x 192 x 4705 scattered int32
// words (7.2 MB) and writes 2 x 48 x 4705 (1.8 MB); no operation is worth
// counting.  A gather has no reuse for the tensor cores; what it needs is
// enough independent loads in flight to cover the memory latency, in one
// wave.  So each thread owns K consecutive outputs of the flattened
// [nchan / nchan_sum, nvis] planes: it decodes its K pairs once, issues
// all 2 K nchan_sum loads before its first add (nchan_sum is a template
// parameter, so the loads unroll), and writes each plane's K sums as one
// 16-byte store; neighbouring threads write neighbouring 16 bytes.  The
// flat index lets a thread's outputs run across the end of a row, so the
// stores stay 16-byte aligned whatever nvis is.  The grid covers the
// outputs in one wave where it can (64-thread blocks spread them evenly
// over the SMs) and strides over them where it cannot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int K = 4;  // outputs per thread: one 16-byte store per plane

// NS > 0: nchan_sum == NS, known to the compiler.  NS == 0: the same body
// for any other nchan_sum, its channels taken GENERIC_CHUNK at a time.
constexpr int GENERIC_CHUNK = 4;

template <int NS>
__global__ void __launch_bounds__(THREADS)
subsel_gather_kernel(const int* __restrict__ vis_r,
                     const int* __restrict__ vis_i, int ninput,
                     const int* __restrict__ pairs, int nvis, int nchan_sum,
                     long long nout, bool vector_stores,
                     int* __restrict__ out_r, int* __restrict__ out_i)
{
    constexpr int W = NS > 0 ? NS : GENERIC_CHUNK;
    const int ns = NS > 0 ? NS : nchan_sum;
    const long long plane = static_cast<long long>(ninput) * ninput;
    const long long stride = static_cast<long long>(gridDim.x) * THREADS * K;
    for (long long f0 = (static_cast<long long>(blockIdx.x) * THREADS
                         + threadIdx.x) * K;
         f0 < nout; f0 += stride) {
        // decode: output f0 + k is (channel group co, baseline v)
        long long base[K];
        int sign[K];
        int co = static_cast<int>(f0 / nvis);
        int v = static_cast<int>(f0 - static_cast<long long>(co) * nvis);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (f0 + k < nout) {
                const int a = min(max(pairs[2 * v], 0), ninput - 1);
                const int b = min(max(pairs[2 * v + 1], 0), ninput - 1);
                sign[k] = a <= b ? 1 : -1;
                base[k] = static_cast<long long>(co) * ns * plane
                          + static_cast<long long>(min(a, b)) * ninput
                          + max(a, b);
            } else {
                sign[k] = 0;
                base[k] = -1;
            }
            if (++v == nvis) {
                v = 0;
                ++co;
            }
        }
        int sr[K] = {}, si[K] = {};
        for (int s0 = 0; s0 < ns; s0 += W) {
            // every load of the chunk is issued before the first add
            int r[K][W], im[K][W];
#pragma unroll
            for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int s = 0; s < W; ++s) {
                    const bool live = base[k] >= 0 && (NS > 0 || s0 + s < ns);
                    const long long o = base[k] + (s0 + s) * plane;
                    r[k][s] = live ? __ldg(vis_r + o) : 0;
                    im[k][s] = live ? __ldg(vis_i + o) : 0;
                }
            }
#pragma unroll
            for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int s = 0; s < W; ++s) {
                    sr[k] += r[k][s];
                    si[k] += im[k][s];
                }
            }
        }
        if (vector_stores && f0 + K <= nout) {
            int4 vr, vi;
            vr.x = sr[0];
            vr.y = sr[1];
            vr.z = sr[2];
            vr.w = sr[3];
            vi.x = sign[0] * si[0];
            vi.y = sign[1] * si[1];
            vi.z = sign[2] * si[2];
            vi.w = sign[3] * si[3];
            *reinterpret_cast<int4*>(out_r + f0) = vr;
            *reinterpret_cast<int4*>(out_i + f0) = vi;
        } else {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (f0 + k < nout) {
                    out_r[f0 + k] = sr[k];
                    out_i[f0 + k] = sign[k] * si[k];
                }
            }
        }
    }
}

template <int NS>
int launch(const int* vis_r, const int* vis_i, int ninput, const int* pairs,
           int nvis, int nchan_sum, long long nout, int* out_r, int* out_i,
           cudaStream_t stream)
{
    // one wave: as many blocks as the SMs hold at the occupancy of this
    // instantiation, fewer where the outputs need fewer
    static const int per_sm = [] {
        int n = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, subsel_gather_kernel<NS>, THREADS, 0);
        return n;
    }();
    int dev = 0, nsm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    const long long need = (nout + THREADS * K - 1) / (THREADS * K);
    const long long wave = static_cast<long long>(max(nsm, 1))
                           * max(per_sm, 1);
    const int grid = static_cast<int>(need < wave ? need : wave);
    if (grid == 0) {
        return static_cast<int>(cudaGetLastError());
    }
    const bool vector_stores =
        ((reinterpret_cast<uintptr_t>(out_r)
          | reinterpret_cast<uintptr_t>(out_i)) & 15) == 0;
    subsel_gather_kernel<NS><<<grid, THREADS, 0, stream>>>(
        vis_r, vis_i, ninput, pairs, nvis, nchan_sum, nout, vector_stores,
        out_r, out_i);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vis: int32 planes [nchan, ninput, ninput], contiguous; pairs: int32
// [nvis, 2]; out: int32 [nchan / nchan_sum, nvis].  Returns
// cudaGetLastError() after the launch.
extern "C" int cbd_subsel_gather(const void* vis_r, const void* vis_i,
                                 int nchan, int ninput, const void* pairs,
                                 int nvis, int nchan_sum, void* out_r,
                                 void* out_i, void* stream)
{
    if (nchan_sum <= 0 || nchan % nchan_sum != 0 || ninput <= 0
        || nvis < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long nout = static_cast<long long>(nchan / nchan_sum) * nvis;
    const auto* vr = static_cast<const int*>(vis_r);
    const auto* vi = static_cast<const int*>(vis_i);
    const auto* p = static_cast<const int*>(pairs);
    auto* orr = static_cast<int*>(out_r);
    auto* oi = static_cast<int*>(out_i);
    auto* s = static_cast<cudaStream_t>(stream);
    switch (nchan_sum) {
    case 1:
        return launch<1>(vr, vi, ninput, p, nvis, 1, nout, orr, oi, s);
    case 2:
        return launch<2>(vr, vi, ninput, p, nvis, 2, nout, orr, oi, s);
    case 4:
        return launch<4>(vr, vi, ninput, p, nvis, 4, nout, orr, oi, s);
    case 8:
        return launch<8>(vr, vi, ninput, p, nvis, 8, nout, orr, oi, s);
    default:
        return launch<0>(vr, vi, ninput, p, nvis, nchan_sum, nout, orr, oi,
                         s);
    }
}

extern "C" const char* cbd_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
