// A host stand-in for <cuda_runtime.h>: enough of the CUDA C++ surface to
// compile a kernel source of the port with g++ and run it on CPU pointers,
// so its index arithmetic, fragment maps and masking can be held against
// the plain versions without a GPU (tests/test_torch_kernel_emulation.py).
//
// A block's threads run as std::threads, blocks one after another;
// __syncthreads is a std::barrier over the block.  The test rewrites each
// ``kernel<<<grid, block, smem, stream>>>(`` to
// ``cbd_emu::launcher(kernel, grid, block, smem, stream)(`` and each
// ``extern __shared__ T name[];`` to a pointer into the launch's buffer.
// Sources that define CBD_HOST_EMULATION-guarded device functions get the
// tensor-core instruction lane by lane from here: every lane of a warp
// publishes its fragment registers, and each lane then computes its own
// accumulator elements from the PTX fragment layout.
#pragma once
#define CBD_HOST_EMULATION 1

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
        : x(x_), y(y_), z(z_) {}
};
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w)
{
    return float4{x, y, z, w};
}
template <class T>
inline T __ldg(const T* p) { return *p; }
using std::max;
using std::min;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int)
{
    return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace cbd_emu {

constexpr int WARP = 32;

struct Block {
    std::barrier<> all;
    std::vector<std::unique_ptr<std::barrier<>>> warp;
    // fragment registers published by each lane: [warp][lane][a0-3, b0-1]
    std::vector<int> frag;
    std::vector<double> frag64;
    std::vector<unsigned char> dynamic;

    Block(int nthread, size_t nbyte)
        : all(nthread), frag(static_cast<size_t>(nthread) * 6),
          frag64(static_cast<size_t>(nthread) * 6), dynamic(nbyte + 16)
    {
        for (int w = 0; w * WARP < nthread; ++w) {
            const int n = nthread - w * WARP < WARP ? nthread - w * WARP
                                                    : WARP;
            warp.push_back(std::make_unique<std::barrier<>>(n));
        }
    }
};

inline thread_local dim3 thread_idx, block_idx, block_dim, grid_dim;
inline thread_local Block* block = nullptr;

inline void* dynamic_shared()
{
    auto p = reinterpret_cast<uintptr_t>(block->dynamic.data());
    return reinterpret_cast<void*>((p + 15) & ~uintptr_t(15));
}

template <class F>
struct Launcher {
    F kernel;
    dim3 grid, threads;
    size_t nbyte;

    template <class... Args>
    void operator()(Args... args) const
    {
        const int n = static_cast<int>(threads.x * threads.y * threads.z);
        for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
            Block blk(n, nbyte);
            std::vector<std::thread> pool;
            for (int tid = 0; tid < n; ++tid) {
                pool.emplace_back([=, &blk, this] {
                    thread_idx = dim3(tid % threads.x,
                                      tid / threads.x % threads.y,
                                      tid / (threads.x * threads.y));
                    block_idx = dim3(bx, by, bz);
                    block_dim = threads;
                    grid_dim = grid;
                    block = &blk;
                    kernel(args...);
                });
            }
            for (auto& th : pool) {
                th.join();
            }
        }
    }
};

template <class F>
inline Launcher<F> launcher(F kernel, dim3 grid, dim3 threads,
                            size_t nbyte = 0, cudaStream_t = nullptr)
{
    return Launcher<F>{kernel, grid, threads, nbyte};
}

inline int linear_tid()
{
    return static_cast<int>(thread_idx.x + block_dim.x
                            * (thread_idx.y + block_dim.y * thread_idx.z));
}

// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 from the PTX fragment
// layout (g = lane / 4, t = lane % 4):
//   A[row][k]: lane (row % 8) * 4 + (k % 16) / 4, register row / 8 +
//              2 * (k / 16), byte k % 4
//   B[k][col]: lane col * 4 + (k % 16) / 4, register k / 16, byte k % 4
//   C[row][col]: lane (row % 8) * 4 + col / 2, register 2 * (row / 8) +
//              col % 2
inline void mma_m16n8k32_s8(int (&c)[4], const int (&a)[4],
                            const int (&b)[2])
{
    const int tid = linear_tid();
    const int lane = tid % WARP;
    const int w = tid / WARP;
    int* mine = block->frag.data() + static_cast<size_t>(tid) * 6;
    for (int r = 0; r < 4; ++r) mine[r] = a[r];
    for (int r = 0; r < 2; ++r) mine[4 + r] = b[r];
    block->warp[w]->arrive_and_wait();
    const int* regs = block->frag.data() + static_cast<size_t>(w) * WARP * 6;
    const int g = lane / 4, t = lane % 4;
    for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e / 2);
        const int col = 2 * t + e % 2;
        int sum = 0;
        for (int k = 0; k < 32; ++k) {
            const int la = (row % 8) * 4 + (k % 16) / 4;
            const int ra = row / 8 + 2 * (k / 16);
            const int lb = col * 4 + (k % 16) / 4;
            const int rb = 4 + k / 16;
            const int av = static_cast<int8_t>(
                static_cast<unsigned>(regs[la * 6 + ra]) >> (8 * (k % 4)));
            const int bv = static_cast<int8_t>(
                static_cast<unsigned>(regs[lb * 6 + rb]) >> (8 * (k % 4)));
            sum += av * bv;
        }
        c[e] += sum;
    }
    block->warp[w]->arrive_and_wait();
}

// mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64:
//   A[row][k]: lane (row % 8) * 4 + k % 4, register row / 8 + 2 * (k / 4)
//   B[k][col]: lane col * 4 + k % 4, register k / 4
//   C[row][col]: as above
inline void mma_m16n8k8_f64(double (&c)[4], const double (&a)[4],
                            const double (&b)[2])
{
    const int tid = linear_tid();
    const int lane = tid % WARP;
    const int w = tid / WARP;
    double* mine = block->frag64.data() + static_cast<size_t>(tid) * 6;
    for (int r = 0; r < 4; ++r) mine[r] = a[r];
    for (int r = 0; r < 2; ++r) mine[4 + r] = b[r];
    block->warp[w]->arrive_and_wait();
    const double* regs = block->frag64.data()
                         + static_cast<size_t>(w) * WARP * 6;
    const int g = lane / 4, t = lane % 4;
    for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e / 2);
        const int col = 2 * t + e % 2;
        double sum = c[e];
        for (int k = 0; k < 8; ++k) {
            const int la = (row % 8) * 4 + k % 4;
            const int ra = row / 8 + 2 * (k / 4);
            const int lb = col * 4 + k % 4;
            const int rb = 4 + k / 4;
            sum = std::fma(regs[la * 6 + ra], regs[lb * 6 + rb], sum);
        }
        c[e] = sum;
    }
    block->warp[w]->arrive_and_wait();
}

inline void cp_async16(void* shared, const void* global)
{
    std::memcpy(shared, global, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
template <int N>
inline void cp_async_wait_but() {}

}  // namespace cbd_emu

#define threadIdx cbd_emu::thread_idx
#define blockIdx cbd_emu::block_idx
#define blockDim cbd_emu::block_dim
#define gridDim cbd_emu::grid_dim

inline void __syncthreads() { cbd_emu::block->all.arrive_and_wait(); }
