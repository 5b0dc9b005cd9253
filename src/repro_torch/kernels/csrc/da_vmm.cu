// LUT-readout Distributed-Arithmetic VMM for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/da_vmm.py: _da_vmm_kernel
// (driven by da_vmm_pallas; engine backend pallas_lut), and that kernel
// batched over stacked experts: jax.vmap of it in src/repro/core/engine.py:
// dense lowers to one pallas_call whose grid leads with the expert.
//
// Computes the exact int32 Y[m, n] = sum_b coef(b) * sum_g LUT[g, addr(m, b, g), n]
// with addr(m, b, g) = sum_i bit_b(xq[m, g*L + i] & mask) << i, the paper's
// datapath: PMA address decode, weight-sum readout, shift-and-add.  coef(b) =
// 2^b, except -2^(x_bits-1) on the sign plane of two's-complement codes; the
// multiply by coef(b) is a shift and an add or a subtract.  Everything stays in
// int32 (wrapping, as the reference's int32 does), so the result is exact: the
// TPU kernel's fp32 2^24 argument does not arise.
//
// The x_bits addresses of one (token, group) are computed once, not per
// column: the group's L codes (masked to x_bits, so signed codes give their
// two's-complement pattern) are the bytes of a 64-bit word, and an 8x8
// bit-matrix transpose turns byte i = code i into byte b = address of plane b
// (two words for L > 8).  K is padded to whole groups: padded codes are 0 and
// address row 0, which is 0.
//
// What bounds it on this card.  Per group a token reads x_bits rows of N int32,
// so a call reads at most min(M * x_bits, 2^L) distinct rows per group: the
// bytes of the addressed rows over 3.35 TB/s bound it (the int32 adds are
// M * x_bits * G * N, far below the CUDA cores' rate).  At decode those rows
// are few and the bound is a few microseconds: what costs is latency, so the
// design puts as many independent row loads in flight as it can.
//
// Design.  Groups are a reduction axis: int32 addition wraps, so partial sums
// over any split of the groups add to the same bits in any order.  The grid
// is (token tiles, column tiles, group ranges), sized on the host from the
// SM count (kernels/da_vmm.py: lut_plan) so every shape gets at least about
// one block per SM; with more than one range the entry point zeroes the
// output (cudaMemsetAsync) and blocks add their partials with atomicAdd.
// Stacked experts (tables [E, G, 2^L, N]) run in the same launch: z is
// expert x group range, and a block offsets its codes, tables and output by
// its expert's strides, taken in 64 bits.
// A block of 1-4 warps owns one token (two above M = 8) x 32*V columns
// (V = 4: one 16-byte vector per lane) and a range of at most 8 groups; each
// warp takes its groups one at a time, forms the addresses (one lane per
// token, shuffled to the warp) with the codes' loads all in flight together,
// then issues every (token, plane) row of the group before any shift-and-add.
// Many small blocks keep many independent row loads in flight: at decode the
// bound is latency, not bytes.  The warps' partials meet in shared memory.
// At prefill repeated rows come from L2 for every table but the LM head's
// (262 MB); staging each group's slice in shared memory was measured and lost
// wherever L2 holds the tables (PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int G_WARPS = 4;       // most warps of a block

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

// token row xr's address words for group g: byte b of lo | hi << 8 is the
// address of plane b (codes past K are 0)
__device__ __forceinline__ void group_addr(const int32_t* __restrict__ xr, int g, int L,
                                           int K, unsigned mask, uint64_t& lo,
                                           uint64_t& hi) {
  lo = 0;
  hi = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // unrolled: all L loads in flight at once
    const int k = g * L + i;
    const uint64_t c =
        i < L && k < K ? (uint64_t)((unsigned)__ldg(xr + k) & mask) : 0ull;
    if (i < 8)
      lo |= c << (8 * i);
    else
      hi |= c << (8 * (i - 8));
  }
  lo = transpose8(lo);
  hi = transpose8(hi);
}

template <int V>
struct Row {
  unsigned v[V];
};

template <int V>
__device__ __forceinline__ Row<V> load_row(const int32_t* __restrict__ p) {
  Row<V> r;
  if constexpr (V == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = (unsigned)__ldg(p);
  }
  return r;
}

// plane b's row into acc: shift-and-add, the sign plane subtracts
__device__ __forceinline__ unsigned shift_add(unsigned acc, unsigned v, int b,
                                              int sign_plane) {
  return b == sign_plane ? acc - (v << b) : acc + (v << b);
}

// V columns per lane (4: N % 4 == 0, the table 16-byte
// aligned), BM tokens per block, blockDim.x / 32 warps, gpb groups per block.
template <int V, int BM>
__global__ void __launch_bounds__(G_WARPS * 32)
lut_gather_kernel(const int32_t* __restrict__ xq, const int32_t* __restrict__ luts,
                  int32_t* __restrict__ out, int M, int K, int N, int G, int L,
                  int x_bits, int x_signed, int gpb, long long sxe, long long sle,
                  long long soe, int atomic) {
  constexpr int COLS = 32 * V;
  constexpr int ITEMS = BM * 8;  // (token, plane) rows of one group
  __shared__ unsigned red[G_WARPS][BM][COLS];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ranges = (G + gpb - 1) / gpb;
  const int e = blockIdx.z / ranges;
  const int g_begin = (blockIdx.z - e * ranges) * gpb;
  xq += e * sxe;
  luts += e * sle;
  out += e * soe;
  const int nb = blockIdx.y * COLS;
  const int n = nb + lane * V;
  const bool live = n < N;  // V = 4: N % 4 == 0, so all four columns are
  const int m0 = blockIdx.x * BM;
  const int mc = min(BM, M - m0);
  const int g_end = min(G, g_begin + gpb);
  const unsigned mask = (1u << x_bits) - 1u;
  const int sign_plane = x_signed ? x_bits - 1 : -1;
  const size_t rows = (size_t)1 << L;

  unsigned acc[BM][V];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0u;

  for (int g = g_begin + warp; g < g_end; g += nw) {
    // lane m < mc forms token m0 + m's addresses; the other lanes' words are
    // 0 (row 0, all zeros), so a ragged tile adds nothing
    uint64_t lo = 0, hi = 0;
    if (lane < mc) group_addr(xq + (size_t)(m0 + lane) * K, g, L, K, mask, lo, hi);
    uint64_t alo[BM], ahi[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      alo[m] = shfl64(lo, m);
      ahi[m] = L > 8 ? shfl64(hi, m) : 0ull;
    }
    const int32_t* tab = luts + (size_t)g * rows * N + n;
    Row<V> r[ITEMS];  // every row of the group in flight before any add
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int m = j >> 3, b = j & 7;
      if (b < x_bits && live) {
        const unsigned a = (unsigned)((alo[m] >> (8 * b)) & 0xffu) |
                           ((unsigned)((ahi[m] >> (8 * b)) & 0xffu) << 8);
        r[j] = load_row<V>(tab + (size_t)a * N);
      }
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int m = j >> 3, b = j & 7;
      if (b < x_bits && live)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[m][c] = shift_add(acc[m][c], r[j].v[c], b, sign_plane);
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) red[warp][m][lane * V + j] = acc[m][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * COLS; idx += blockDim.x) {
    const int m = idx / COLS, c = idx % COLS;
    if (m < mc && nb + c < N) {
      unsigned s = 0u;
      for (int w = 0; w < nw; ++w) s += red[w][m][c];
      int32_t* o = out + (size_t)(m0 + m) * N + nb + c;
      if (atomic)
        atomicAdd(o, (int32_t)s);
      else
        *o = (int32_t)s;
    }
  }
}

template <int V, int BM>
void launch_gather(dim3 grid, int warps, cudaStream_t st, const int32_t* xq,
                   const int32_t* luts, int32_t* out, int M, int K, int N, int G, int L,
                   int x_bits, int x_signed, int gpb, long long sxe, long long sle,
                   long long soe, int atomic) {
  lut_gather_kernel<V, BM><<<grid, warps * 32, 0, st>>>(
      xq, luts, out, M, K, N, G, L, x_bits, x_signed, gpb, sxe, sle, soe, atomic);
}

template <int V>
int dispatch_gather(int bm, dim3 grid, int warps, cudaStream_t st, const int32_t* xq,
                    const int32_t* luts, int32_t* out, int M, int K, int N, int G,
                    int L, int x_bits, int x_signed, int gpb, long long sxe,
                    long long sle, long long soe, int atomic) {
  switch (bm) {
    case 1: launch_gather<V, 1>(grid, warps, st, xq, luts, out, M, K, N, G, L, x_bits, x_signed, gpb, sxe, sle, soe, atomic); break;
    case 2: launch_gather<V, 2>(grid, warps, st, xq, luts, out, M, K, N, G, L, x_bits, x_signed, gpb, sxe, sle, soe, atomic); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// E experts, each xq int32 [M, K] contiguous, luts int32 [G, 2^L, N]
// contiguous, G * L >= K, and out int32 [M, N] contiguous; expert e's start
// at element e * sxe, e * sle and e * soe of xq, luts and out (64-bit; the
// experts' outputs must not overlap).  E = 1 is one matrix.  1 <= L <= 16,
// 1 <= x_bits <= 8.  The plan (kernels/da_vmm.py: lut_plan): vec 4 or 1
// columns per lane, bm 1 or 2 tokens, warps 1-4 and gpb groups per block.
// With more than one group range every expert's output is zeroed first
// (one more launch).  Adds the CUDA launches it queued to *launched.
int da_vmm_lut_s32(const void* xq, const void* luts, void* out, int E, int M, int K,
                   int N, int G, int L, long long sxe, long long sle, long long soe,
                   int x_bits, int x_signed, int vec, int bm, int gpb, int warps,
                   void* stream, int* launched) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0 || G <= 0 || L < 1 || L > 16 || x_bits < 1 ||
      x_bits > 8 || (long long)G * L < K || gpb < 1 || bm < 1)
    return (int)cudaErrorInvalidValue;
  if ((vec != 4 && vec != 1) || (vec == 4 && N % 4) || bm > 2 || warps < 1 ||
      warps > G_WARPS)
    return (int)cudaErrorInvalidValue;
  // vec 4 reads 16-byte rows of every expert's tables
  if (E > 1 && (sxe < 0 || sle < 0 || soe < (long long)M * N || (vec == 4 && sle % 4)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = 32 * vec;
  const int ranges = (G + gpb - 1) / gpb;
  if ((N + cols - 1) / cols > 65535 || (long long)E * ranges > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + bm - 1) / bm, (N + cols - 1) / cols, E * ranges);
  const int atomic = ranges > 1;
  const int32_t* x = static_cast<const int32_t*>(xq);
  const int32_t* t = static_cast<const int32_t*>(luts);
  int32_t* y = static_cast<int32_t*>(out);
  cudaError_t err;
  if (atomic) {
    // the span from expert 0's output to the end of expert E - 1's
    err = cudaMemsetAsync(out, 0, ((size_t)(E - 1) * soe + (size_t)M * N) * sizeof(int32_t),
                          st);
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  const int e = vec == 4 ? dispatch_gather<4>(bm, grid, warps, st, x, t, y, M, K, N, G, L,
                                              x_bits, x_signed, gpb, sxe, sle, soe, atomic)
                         : dispatch_gather<1>(bm, grid, warps, st, x, t, y, M, K, N, G, L,
                                              x_bits, x_signed, gpb, sxe, sle, soe, atomic);
  if (e) return e;
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // extern "C"
