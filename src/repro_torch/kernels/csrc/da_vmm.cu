// LUT-readout Distributed-Arithmetic VMM for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/da_vmm.py: _da_vmm_kernel
// (driven by da_vmm_pallas; engine backend pallas_lut).
//
// Computes the exact int32 Y[m, n] = sum_b coef(b) * sum_g LUT[g, addr(m, b, g), n]
// with addr(m, b, g) = sum_i bit_b(xq[m, g*L + i] & mask) << i, the paper's
// datapath: PMA address decode, weight-sum readout, shift-and-add.  coef(b) =
// 2^b, except -2^(x_bits-1) on the sign plane of two's-complement codes; the
// multiply by coef(b) is a shift and an add or a subtract.  Everything stays in
// int32 (wrapping, as the reference's int32 does), so the result is exact: the
// TPU kernel's fp32 2^24 argument does not arise.
//
// Design.  The TPU kernel builds a one-hot matrix of each group's addresses
// and multiplies it with the LUT on the MXU.  On Hopper the decoder becomes a
// direct gather: for each (token m, plane b, group g) a warp reads row
// LUT[g, addr, n0 : n0 + 128] (each lane one 16-byte vector when N % 4 == 0)
// and shifts and adds it into int32 registers.  The x_bits addresses of one
// (token, group) are computed once, not per column: one lane loads the
// group's L codes (masked to x_bits, so signed codes give their
// two's-complement pattern) as the bytes of a 64-bit word, an 8x8 bit-matrix
// transpose turns byte i = code i into byte b = address of plane b (two words
// for L > 8), and shuffles hand the addresses to the warp.  K is padded to
// whole groups: padded codes are 0 and address row 0, which is 0.  One block
// of 8 warps per (8-token tile, 128-column tile); the warps split the groups
// and sum their partials through shared memory.
//
// What bounds it on this card.  Per group a token reads x_bits rows of N int32,
// so the kernel reads at most min(M * x_bits, 2^L) distinct rows per group:
// the bytes of the addressed rows, over 3.35 TB/s, bound it (the int32 adds
// are M * x_bits * G * N, far below the CUDA cores' rate).  Repeated addresses
// hit in L1/L2.  A tile of 8 tokens leaves decode (M = 4) with few blocks for
// narrow N; staging a group's table in shared memory when M * x_bits nears
// 2^L (prefill) and splitting G across blocks are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int BM = 8;          // tokens per block
constexpr int BN = 32 * 4;     // columns per block: 4 per lane
constexpr unsigned FULL = 0xffffffffu;

// 8x8 bit-matrix transpose of the bytes of x: bit j of byte i moves to bit i
// of byte j (Hacker's Delight, transpose8rS64)
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x = x ^ t ^ (t << 28);
  return x;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  const unsigned lo = __shfl_sync(FULL, (unsigned)v, src);
  const unsigned hi = __shfl_sync(FULL, (unsigned)(v >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}

// four consecutive columns of one LUT row starting at column n (n < N)
template <bool VEC>
__device__ __forceinline__ uint4 load_row4(const int32_t* __restrict__ row, int n, int N) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(row + n));
  } else {
    uint4 r;
    r.x = (unsigned)__ldg(row + n);
    r.y = n + 1 < N ? (unsigned)__ldg(row + n + 1) : 0u;
    r.z = n + 2 < N ? (unsigned)__ldg(row + n + 2) : 0u;
    r.w = n + 3 < N ? (unsigned)__ldg(row + n + 3) : 0u;
    return r;
  }
}

// VEC: N % 4 == 0, so every lane's four columns are one aligned 16-byte vector
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
da_vmm_lut_kernel(const int32_t* __restrict__ xq, const int32_t* __restrict__ luts,
                  int32_t* __restrict__ out, int M, int K, int N, int G, int L,
                  int x_bits, int x_signed) {
  __shared__ unsigned red[NWARPS][BM][BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = blockIdx.x * BN;
  const int n = nb + lane * 4;
  const int m0 = blockIdx.y * BM;
  const int mc = min(BM, M - m0);
  const unsigned mask = (1u << x_bits) - 1u;
  const int sign_plane = x_signed ? x_bits - 1 : -1;
  const size_t rows = (size_t)1 << L;

  unsigned acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0u;

  for (int g = warp; g < G; g += NWARPS) {
    // lane m < mc: byte b of lo | hi << 8 is token m0 + m's address in plane b
    uint64_t lo = 0, hi = 0;
    if (lane < mc) {
      const int32_t* xr = xq + (size_t)(m0 + lane) * K;
      for (int i = 0; i < L; ++i) {
        const int k = g * L + i;
        const uint64_t c = k < K ? (uint64_t)((unsigned)xr[k] & mask) : 0ull;
        if (i < 8)
          lo |= c << (8 * i);
        else
          hi |= c << (8 * (i - 8));
      }
      lo = transpose8(lo);
      hi = transpose8(hi);
    }
    const int32_t* tab = luts + (size_t)g * rows * N;
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m >= mc) break;
      const uint64_t alo = shfl64(lo, m), ahi = shfl64(hi, m);
      if (n < N) {
        uint4 r[8];  // every plane's row in flight before any add
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (b < x_bits) {
            const unsigned addr = (unsigned)((alo >> (8 * b)) & 0xffu) |
                                  ((unsigned)((ahi >> (8 * b)) & 0xffu) << 8);
            r[b] = load_row4<VEC>(tab + (size_t)addr * N, n, N);
          }
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (b < x_bits) {
            // shift-and-add; the sign plane subtracts
            const unsigned v[4] = {r[b].x << b, r[b].y << b, r[b].z << b, r[b].w << b};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[m][j] = b == sign_plane ? acc[m][j] - v[j] : acc[m][j] + v[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int m = idx / BN, c = idx % BN;
    if (m < mc && nb + c < N) {
      unsigned s = 0u;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[w][m][c];
      out[(size_t)(m0 + m) * N + nb + c] = (int32_t)s;
    }
  }
}

}  // namespace

extern "C" {

// xq int32 [M, K] contiguous; luts int32 [G, 2^L, N] contiguous, G * L >= K;
// out int32 [M, N] contiguous.  1 <= L <= 16, 1 <= x_bits <= 8.
int da_vmm_lut_s32(const void* xq, const void* luts, void* out, int M, int K, int N,
                   int G, int L, int x_bits, int x_signed, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || L < 1 || L > 16 || x_bits < 1 ||
      x_bits > 8 || (long long)G * L < K)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (N % 4 == 0)
    da_vmm_lut_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)xq, (const int32_t*)luts, (int32_t*)out, M, K, N, G, L, x_bits,
        x_signed);
  else
    da_vmm_lut_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)xq, (const int32_t*)luts, (int32_t*)out, M, K, N, G, L, x_bits,
        x_signed);
  return (int)cudaGetLastError();
}

}  // extern "C"
