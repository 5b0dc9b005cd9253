// Latency and rate of the float64 MMA shapes (DMMA) on the card: each warp
// runs ITERS rounds of C independent accumulator chains of one shape, on one
// warp (latency, then one warp's issue rate) and on 8 warps x 2 blocks per
// SM over the whole card (the card's rate).  The paged-attention kernel's
// products use one of these shapes (kernels/csrc/paged_attention.cu).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o dmma_rate tools/dmma_rate.cu
//   ./dmma_rate
#include <cstdio>

#include <cuda_runtime.h>

template <int C>
__global__ void m8n8k4(double* out, int iters, long long* cycles) {
  const double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  double d[C][2];
  for (int c = 0; c < C; ++c) d[c][0] = d[c][1] = c;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
                   "{%0,%1};\n"
                   : "+d"(d[c][0]), "+d"(d[c][1])
                   : "d"(a), "d"(b));
  }
  const long long t1 = clock64();
  double s = 0;
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

template <int C>
__global__ void m16n8k4(double* out, int iters, long long* cycles) {
  const double a0 = threadIdx.x * 1e-3, a1 = a0 + 1, b = 1.0 + threadIdx.x * 1e-4;
  double d[C][4];
  for (int c = 0; c < C; ++c) d[c][0] = d[c][1] = d[c][2] = d[c][3] = c;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, "
                   "{%6}, {%0,%1,%2,%3};\n"
                   : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
                   : "d"(a0), "d"(a1), "d"(b));
  }
  const long long t1 = clock64();
  double s = 0;
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

template <typename K>
void run(const char* name, K kernel, int fma_per_lane, int chains, int blocks, int warps) {
  double* out;
  long long* cycles;
  cudaMalloc(&out, (size_t)blocks * warps * 32 * sizeof(double));
  cudaMalloc(&cycles, sizeof(long long));
  const int iters = 2000;
  kernel<<<blocks, warps * 32>>>(out, iters, cycles);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<blocks, warps * 32>>>(out, iters, cycles);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c = 0;
  cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  const double mmas = (double)blocks * warps * iters * chains;
  printf("%-8s chains %d blocks %4d warps %d: %.1f cycles per MMA per warp, %.2f TFLOP/s (%s)\n",
         name, chains, blocks, warps, (double)c / iters / chains,
         mmas * fma_per_lane * 32 * 2 / (ms * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(cycles);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run("m8n8k4", m8n8k4<1>, 8, 1, 1, 1);
  run("m8n8k4", m8n8k4<8>, 8, 8, 1, 1);
  run("m8n8k4", m8n8k4<8>, 8, 8, 2 * sms, 8);
  run("m16n8k4", m16n8k4<1>, 16, 1, 1, 1);
  run("m16n8k4", m16n8k4<8>, 16, 8, 1, 1);
  run("m16n8k4", m16n8k4<8>, 16, 8, 2 * sms, 8);
  return 0;
}
