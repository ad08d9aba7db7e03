// Baseline subselection gather with channel sum, for sm_90a.
//
// Replaces the TPU kernels caltech_bifrost_dsp_tpu/ops/pallas/
// subsel_gather.py::block_extract and ::band_extract together with the
// XLA take/sign/channel-sum around them (ops/corr_subsel.py::
// corr_subsel_bands).  The TPU slabs exist only to shrink XLA's gather
// operand; here the function is ported directly, one thread per output
// (c', v):
//
//     out[c', v] = sign_v * sum_{c in group(c')} M[c, lo_v, hi_v]
//
// read straight from the upper-valid accumulators, with both inputs of a
// pair clamped to [0, ninput - 1] before lo, hi and the sign are taken
// (xengine.py:94-99 and corr_subsel.py:83-91).
//
// Bound: latency and launch.  At 4704 baselines and 48 output channels
// the kernel reads 2 x 4 x 4704 x 48 scattered int32 words (7 MB of
// sectors at most) and writes 1.8 MB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
subsel_gather_kernel(const int* __restrict__ vis_r,
                     const int* __restrict__ vis_i, int ninput,
                     const int* __restrict__ pairs, int nvis, int nchan_sum,
                     int* __restrict__ out_r, int* __restrict__ out_i)
{
    const int v = blockIdx.x * THREADS + threadIdx.x;
    const int co = blockIdx.y;
    if (v >= nvis) {
        return;
    }
    const int a = min(max(pairs[2 * v], 0), ninput - 1);
    const int b = min(max(pairs[2 * v + 1], 0), ninput - 1);
    const int lo = min(a, b);
    const int hi = max(a, b);
    const int sign = a <= b ? 1 : -1;
    const long long plane = static_cast<long long>(ninput) * ninput;
    const long long ofs = static_cast<long long>(lo) * ninput + hi;
    int sr = 0, si = 0;
    for (int s = 0; s < nchan_sum; ++s) {
        const long long o = static_cast<long long>(co * nchan_sum + s) * plane
                            + ofs;
        sr += vis_r[o];
        si += vis_i[o];
    }
    out_r[static_cast<long long>(co) * nvis + v] = sr;
    out_i[static_cast<long long>(co) * nvis + v] = sign * si;
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
    if (nchan_sum <= 0 || nchan % nchan_sum != 0 || ninput <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((nvis + THREADS - 1) / THREADS, nchan / nchan_sum);
    subsel_gather_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vis_r), static_cast<const int*>(vis_i),
        ninput, static_cast<const int*>(pairs), nvis, nchan_sum,
        static_cast<int*>(out_r), static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbd_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
