// Probe of the H100's FP64 tensor-core MMA shapes: checks the m16n8k8
// fragment layout that csrc/pfb_quantize.cu relies on against a host
// product, and times m8n8k4, m16n8k4, m16n8k8 and m16n8k16 from registers
// (8 independent accumulators a warp, 8 warps a block, 4 blocks an SM).
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o dmma_probe \
//         caltech_bifrost_dsp_tpu_torch/scripts/dmma_probe.cu && ./dmma_probe
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W: m8n8k4 33.3, m16n8k4 58.0-58.6,
// m16n8k8 63.8-64.0, m16n8k16 65.8-65.9 TFLOP/s; layout: 0 mismatches.
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma884(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n" : "+d"(c[0]), "+d"(c[1]) : "d"(a), "d"(b));
}
__device__ __forceinline__ void mma1688(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
   : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma1684(double (&c)[4], const double (&a)[2], double b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
   : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b));
}
__device__ __forceinline__ void mma16816(double (&c)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
   : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
// layout check for m16n8k8: A[16][8], B[8][8] row-major inputs, C[16][8] out
__global__ void layout1688(const double* A, const double* B, double* C) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[4] = {A[g*8+t], A[(g+8)*8+t], A[g*8+t+4], A[(g+8)*8+t+4]};
  double b[2] = {B[t*8+g], B[(t+4)*8+g]};
  double c[4] = {0,0,0,0};
  mma1688(c, a, b);
  C[g*8+2*t] = c[0]; C[g*8+2*t+1] = c[1]; C[(g+8)*8+2*t] = c[2]; C[(g+8)*8+2*t+1] = c[3];
}
template <int KIND> __global__ void __launch_bounds__(256) thru(double* out, int iters, double seed) {
  double acc[8][4];
  for (int i = 0; i < 8; ++i) for (int e = 0; e < 4; ++e) acc[i][e] = 0;
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = seed + threadIdx.x + i;
  for (int i = 0; i < 4; ++i) b[i] = seed * 0.5 + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (KIND == 0) { double (&c2)[2] = *reinterpret_cast<double(*)[2]>(&acc[i][0]); mma884(c2, a[i & 7], b[i & 3]); double (&c3)[2] = *reinterpret_cast<double(*)[2]>(&acc[i][2]); mma884(c3, a[(i+1) & 7], b[i & 3]); }
      if (KIND == 1) { const double (&a2)[2] = *reinterpret_cast<const double(*)[2]>(&a[(i&3)*2]); mma1684(acc[i], a2, b[i & 3]); }
      if (KIND == 2) { const double (&a4)[4] = *reinterpret_cast<const double(*)[4]>(&a[(i&1)*4]); const double (&b2)[2] = *reinterpret_cast<const double(*)[2]>(&b[(i&1)*2]); mma1688(acc[i], a4, b2); }
      if (KIND == 3) { mma16816(acc[i], a, b); }
    }
  }
  double s = 0; for (int i = 0; i < 8; ++i) for (int e = 0; e < 4; ++e) s += acc[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  double hA[128], hB[64], hC[128], *A, *B, *C;
  for (int i = 0; i < 128; ++i) hA[i] = (i * 7 % 23) - 11;
  for (int i = 0; i < 64; ++i) hB[i] = (i * 5 % 19) - 9;
  cudaMalloc(&A, sizeof hA); cudaMalloc(&B, sizeof hB); cudaMalloc(&C, sizeof hC);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice); cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout1688<<<1, 32>>>(A, B, C); cudaMemcpy(hC, C, sizeof hC, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < 16; ++i) for (int j = 0; j < 8; ++j) { double w = 0; for (int k = 0; k < 8; ++k) w += hA[i*8+k] * hB[k*8+j]; if (w != hC[i*8+j]) ++bad; }
  printf("m16n8k8 layout: %d mismatches (%s)\n", bad, cudaGetErrorString(cudaGetLastError()));
  double* out; int nb = 132 * 4; cudaMalloc(&out, nb * 256 * sizeof(double));
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  const char* names[4] = {"m8n8k4 (x2)", "m16n8k4", "m16n8k8", "m16n8k16"};
  double flops_per[4] = {2 * 2.0*8*8*4, 2.0*16*8*4, 2.0*16*8*8, 2.0*16*8*16};
  int iters = 20000;
  for (int rep = 0; rep < 2; ++rep) for (int k = 0; k < 4; ++k) {
    cudaEventRecord(e0);
    if (k == 0) thru<0><<<nb, 256>>>(out, iters, 1.0); if (k == 1) thru<1><<<nb, 256>>>(out, iters, 1.0);
    if (k == 2) thru<2><<<nb, 256>>>(out, iters, 1.0); if (k == 3) thru<3><<<nb, 256>>>(out, iters, 1.0);
    cudaEventRecord(e1); cudaEventSynchronize(e1); float ms; cudaEventElapsedTime(&ms, e0, e1);
    double fl = (double)nb * 8 * iters * 8 * flops_per[k];
    printf("%s: %.3f ms, %.1f TFLOP/s (%s)\n", names[k], ms, fl / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
