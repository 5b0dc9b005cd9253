// Paged-attention read over fp, int8 or packed-int4 pages for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// _paged_attn_kernel (driven by paged_attention), both its fp branch and its
// quantized branch (kv_fmt != "fp").
//
// Computes, for every batch row b and KV head kv, the grouped-GQA attention
// of its G = H / KV query heads over the pages its page table names:
// scores[g, t, s] = (q[b, t, kv*G+g] . k[page(s), s % ps, kv]) summed in
// float64 and rounded to the input dtype, divided by sqrt(hd) (itself rounded to the input dtype) and
// rounded again, masked to -1e30 where s > tpos[b, t] (where- or additive
// form), then softmax in float32 as exp(x - max) / sum (the sum in float64,
// rounded to float32), probabilities rounded to the input dtype, and the PV
// sum in float64 rounded to the input dtype.  Every rounding is the one the
// gather read (models/attention.paged_gather_read) performs, and it sums in
// float64 too: a sum of products of bfloat16 values is exact in float64 and
// one of float32 values is within 2^-53 of exact, so both reads round the
// same value whatever their summation order, and agree bit for bit.  With the bfloat16 score pipeline (softmax_dtype="bfloat16") the
// scores are rounded to bfloat16 before the mask, and x - max, exp, the row
// sum and the divide are each rounded to bfloat16, as the plain read's
// bfloat16 ops round them.
//
// Quantized pages hold int8 codes [.., hd], or two int4 codes per byte
// [.., hd/2] (element 2i in the low nibble, sign-extended), beside one
// float16 scale per (page slot, KV head) [.., 1] that rides the same table
// walk.  A lane dequantizes its codes in registers with exactly the plain
// formula codes.to(T) * scale.to(T): the f16 scale is rounded to T (f16 ->
// f32 -> T, round to nearest even), then the product is rounded to T.  So
// every dequantized element equals the plain read's.
//
// What bounds it on this card.  At decode (T = 1) the work is about
// 4*H*S*hd flops against 2*S*kv*hd*2 bytes of K and V per row: G = 4 flops
// per byte, so the K/V page stream bounds it (3.35 TB/s); at T = 16 it is
// 64 flops per byte, still below the tensor cores' ridge, but this kernel
// scores and sums with scalar float64 FMAs (34 TFLOP/s), so there the FMAs
// bound it.
// Each live K row is read from device memory once (score launch) and each
// live V row once (PV launch; its re-reads for every 8 query rows hit L2),
// pages the table does not name are never touched, and no gathered
// [B, S, kv, hd] view is materialised.  One block per (KV head, row) walking
// every position would fill only B*KV of the 132 SMs (32 at a qwen3-8b
// decode step) and serialise a long table on one SM.
//
// Design: the positions of a (KV head, row) are split into NS chunks of CW
// whole pages, and two launches over a grid of (KV, B, NS) blocks keep the
// deferred softmax's roundings, which an online softmax would not (it never
// rounds the probabilities to T).  The wrapper picks NS and CW on the host
// from the shapes and the SM count: about two waves of blocks, and at most
// four rounds of U-row loads per warp in a chunk, since a block's rounds run
// one after another (each waits on its loads) while blocks run side by side.
//   (a) score: a block of 8 warps reads its chunk's slice of the page table,
//       scores the chunk's live positions into shared memory (warps take U
//       key positions at a time and load all U K rows before any arithmetic,
//       each lane one vector of hd/32 elements; for 8 query rows at a time a
//       transposing butterfly reduces the 8 lane-partial float64 dots in 9
//       shuffles), then writes them to the float32 workspace [B, KV, G*T, S]
//       and, per query row, the chunk's max m_s;
//   (b) PV: a block takes m = max m_s over the live chunks, sums exp(x - m)
//       over all of the row's live scores in the workspace in float64 (L,
//       rounded to float32), forms p = rnd_T(exp(x - m) / L) for its chunk as
//       the plain read does, and runs the PV pass over its chunk's V rows
//       (each lane accumulates its hd/32 output elements for 8 query rows
//       over U rows loaded at once, in float64; the 8 warp partials are
//       summed in a fixed order through shared memory) into a float64
//       partial [B, KV, NS, G*T, hd].  The last block of a (KV head, row) to
//       finish, found by a counter that the score launch zeroes, sums the
//       live partials in chunk order and rounds to T; a row with one live
//       chunk rounds its block's sum directly.  The counter only elects that
//       block, so the result does not depend on the order blocks run.
// Positions
// past the largest tpos of the row are masked for all its queries: their
// probabilities are exactly 0, so no launch touches them, and a chunk wholly
// past that end is skipped by both launches (each computes the same live end
// from tpos, so nothing marks it).  If no tpos of the row is >= 0 every
// query is masked everywhere and the plain softmax is uniform over all S, so
// nothing is skipped.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int RC = 8;  // query rows per reduction / accumulation chunk
constexpr int U = 8;   // key positions whose rows a warp loads at once
constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may take
enum : int { KV_FP = 0, KV_I8 = 1, KV_I4 = 2 };  // page formats

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float to the input dtype and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// round a float to bfloat16 and back (the bfloat16 score pipeline)
__device__ __forceinline__ float rnd_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// exp(x - max) of a masked score as the plain read forms it: in float32, or
// with x - max and the exp each rounded to bfloat16
__device__ __forceinline__ float softmax_exp(float x, float m, int bf16sm) {
  return bf16sm ? rnd_bf(expf(rnd_bf(x - m))) : expf(x - m);
}

// N consecutive elements at p (aligned to their size when it is a power of
// two) as floats, in as few vector loads as the size allows
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float (&o)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) o[c * PER + j] = to_f<T>(e[j]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = to_f<T>(e[j]);
  } else if constexpr (BYTES == 4) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = to_f<T>(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = to_f<T>(p[j]);
  }
}

// N consecutive bytes at p (aligned to N when N is a power of two)
template <int N>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ p, uint8_t (&o)[N]) {
  if constexpr (N == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const uint8_t* e = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = e[j];
  } else if constexpr (N == 4) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = (uint8_t)(raw >> (8 * j));
  } else if constexpr (N == 2) {
    const unsigned short raw = __ldg(reinterpret_cast<const unsigned short*>(p));
    o[0] = (uint8_t)raw;
    o[1] = (uint8_t)(raw >> 8);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = __ldg(p + j);
  }
}

// a nibble as a sign-extended 4-bit integer
__device__ __forceinline__ int sext4(unsigned x) { return (int)(x << 28) >> 28; }

// This lane's EPL elements of K/V row `row` (page slot * KV + head) as
// floats.  Quantized formats dequantize exactly as the plain read does:
// codes.to(T) * scale.to(T), with both roundings to T.
template <typename T, int EPL, int KF>
__device__ __forceinline__ void load_kv(const void* __restrict__ pool,
                                        const __half* __restrict__ scale, size_t row,
                                        int lane, float (&o)[EPL]) {
  constexpr int HD = 32 * EPL;
  if constexpr (KF == KV_FP) {
    load_f<T, EPL>(reinterpret_cast<const T*>(pool) + row * HD + lane * EPL, o);
  } else {
    const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(scale) + row);
    const float s = rnd<T>(__half2float(__ushort_as_half(bits)));
    float c[EPL];
    if constexpr (KF == KV_I8) {
      uint8_t b[EPL];
      load_bytes<EPL>(reinterpret_cast<const uint8_t*>(pool) + row * HD + lane * EPL, b);
#pragma unroll
      for (int j = 0; j < EPL; ++j) c[j] = (float)(int8_t)b[j];
    } else {
      uint8_t b[EPL / 2];
      load_bytes<EPL / 2>(
          reinterpret_cast<const uint8_t*>(pool) + row * (HD / 2) + lane * (EPL / 2), b);
#pragma unroll
      for (int j = 0; j < EPL / 2; ++j) {
        c[2 * j] = (float)sext4(b[j] & 0xfu);
        c[2 * j + 1] = (float)sext4(b[j] >> 4);
      }
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) o[j] = rnd<T>(c[j] * s);
  }
}

// N consecutive floats of shared memory (16-byte aligned when N % 4 == 0)
template <int N>
__device__ __forceinline__ void lds_f(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 x = reinterpret_cast<const float4*>(p)[c];
      o[4 * c] = x.x; o[4 * c + 1] = x.y; o[4 * c + 2] = x.z; o[4 * c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = p[j];
  }
}

// Sum each of v[0..7] (float or double) over the 32 lanes of the warp.  A transposing
// butterfly: every exchange halves the rows a lane carries, so 9 shuffles
// replace 40.  Lane l ends with the total of row lane_row(l).
template <typename A>
__device__ __forceinline__ A reduce8(A (&v)[RC], int lane) {
  {
    const bool up = lane & 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const A send = up ? v[i] : v[i + 4];
      const A keep = up ? v[i + 4] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const A send = up ? v[i] : v[i + 2];
      const A keep = up ? v[i + 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, 8);
    }
  }
  {
    const bool up = lane & 4;
    const A send = up ? v[0] : v[1];
    const A keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  v[0] += __shfl_xor_sync(FULL, v[0], 2);
  v[0] += __shfl_xor_sync(FULL, v[0], 1);
  return v[0];
}

__device__ __forceinline__ int lane_row(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// End of the live positions of a batch row, [0, s_end): past its largest
// tpos every query is masked.  If no tpos >= 0, every query is masked
// everywhere and the plain softmax is uniform over all S.
__device__ __forceinline__ int live_end(const int32_t* __restrict__ tp, int Tq, int S) {
  int tmax = -1;
  for (int t = 0; t < Tq; ++t) tmax = max(tmax, __ldg(tp + t));
  return tmax >= 0 ? min(S, tmax + 1) : S;
}

// (a) Scores of one chunk.  EPL: head_dim / 32 elements per lane; KF: page
// format (KV_FP pools hold T, quantized pools int8 codes with float16 scales).
// Writes the rounded, masked scores of the chunk's live positions to
// scores [B, KV, G*Tq, S] and the chunk's max per query row to stats [B, KV,
// NS, G*Tq]; the first chunk's block zeroes the (KV head, row)'s counter
// [B, KV] of finished PV blocks.
template <typename T, int EPL, int KF>
__global__ void __launch_bounds__(THREADS)
paged_attn_score_kernel(const T* __restrict__ q, const void* __restrict__ kpool,
                        const __half* __restrict__ kscale,
                        const int32_t* __restrict__ table, const int32_t* __restrict__ tpos,
                        float* __restrict__ scores, float* __restrict__ stats,
                        int* __restrict__ done, int Tq, int H, int KV, int PS, int W,
                        int CW, int NS, float div, int additive, int bf16sm) {
  constexpr int HD = 32 * EPL;
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = H / KV, GT = G * Tq, S = W * PS, CP = CW * PS;
  const int tid = threadIdx.x;
  if (sp == 0 && tid == 0) done[(size_t)b * KV + kvh] = 0;
  const int s_end = live_end(tpos + (size_t)b * Tq, Tq, S);
  const int c0 = sp * CP;
  if (c0 >= s_end) return;
  const int c1 = min(c0 + CP, s_end), n = c1 - c0;
  const int warp = tid >> 5, lane = tid & 31;
  // the masked score, in bfloat16 under the bfloat16 pipeline
  const float neg = bf16sm ? rnd_bf(NEG_INF) : NEG_INF;

  float* q_s = smem;                                    // [GT][HD]
  float* sc_s = q_s + GT * HD;                          // [GT][CP] this chunk
  int* tp_s = reinterpret_cast<int*>(sc_s + GT * CP);   // [Tq]
  int* pg_s = tp_s + Tq;                                // [CW] this chunk's pages

  for (int i = tid; i < GT * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int g = r / Tq, t = r % Tq;
    q_s[i] = to_f<T>(q[(((size_t)b * Tq + t) * H + kvh * G + g) * HD + d]);
  }
  for (int i = tid; i < Tq; i += THREADS) tp_s[i] = tpos[(size_t)b * Tq + i];
  for (int i = tid; i < CW && sp * CW + i < W; i += THREADS)
    pg_s[i] = table[(size_t)b * W + sp * CW + i];
  __syncthreads();
  // K row of position s (page slot, this KV head); c0 is page-aligned
  auto row_of = [&](int s) {
    return ((size_t)pg_s[(s - c0) / PS] * PS + s % PS) * KV + kvh;
  };

  for (int s0 = c0 + warp * U; s0 < c1; s0 += NWARPS * U) {
    float kr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < c1) {
        load_kv<T, EPL, KF>(kpool, kscale, row_of(s0 + u), lane, kr[u]);
      } else {
#pragma unroll
        for (int j = 0; j < EPL; ++j) kr[u][j] = 0.f;
      }
    }
    for (int r0 = 0; r0 < GT; r0 += RC) {
      float qr[RC][EPL];
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        if (r0 + i < GT) {
          lds_f<EPL>(q_s + (r0 + i) * HD + lane * EPL, qr[i]);
        } else {
#pragma unroll
          for (int j = 0; j < EPL; ++j) qr[i][j] = 0.f;
        }
      }
      const int r = r0 + lane_row(lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // rows past G*Tq hold zeros; skipping their FMAs behind a uniform
        // branch made every read slower on the H100 (it cost the unrolling)
        double part[RC];
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          part[i] = 0.0;
#pragma unroll
          for (int j = 0; j < EPL; ++j)
            part[i] = fma((double)qr[i][j], (double)kr[u][j], part[i]);
        }
        const double dot = reduce8(part, lane);
        const int s = s0 + u;
        if ((lane & 3) == 0 && r < GT && s < c1) {
          float v = rnd<T>(rnd<T>((float)dot) / div);
          if (bf16sm) v = rnd_bf(v);
          const bool valid = s <= tp_s[r % Tq];
          if (additive)
            v = v + (valid ? 0.f : neg);
          else
            v = valid ? v : neg;
          if (bf16sm) v = rnd_bf(v);
          sc_s[r * CP + (s - c0)] = v;
        }
      }
    }
  }
  __syncthreads();

  // the chunk's max per query row, starting at the masked value (which a
  // bfloat16 mask rounds below NEG_INF)
  float* st = stats + (((size_t)b * KV + kvh) * NS + sp) * GT;
  for (int r = warp; r < GT; r += NWARPS) {
    const float* row = sc_s + r * CP;
    float m = neg;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    if (lane == 0) st[r] = m;
  }
  float* sc_g = scores + ((size_t)b * KV + kvh) * GT * S;
  for (int i = tid; i < GT * n; i += THREADS) {
    const int r = i / n, s = i % n;
    sc_g[(size_t)r * S + c0 + s] = sc_s[r * CP + s];
  }
}

// (b) PV of one chunk: takes the row's max over the live chunks and its
// exp-sum over all its live scores (float64), forms the rounded
// probabilities of its positions exactly as the plain read does, and writes
// its float64 partial to part [B, KV, NS, G*Tq, HD].  The last of the row's live blocks to finish sums the partials in
// chunk order into out, rounded to T; with one live chunk its block rounds
// its own sum.
template <typename T, int EPL, int KF>
__global__ void __launch_bounds__(THREADS)
paged_attn_pv_kernel(const void* __restrict__ vpool, const __half* __restrict__ vscale,
                     const int32_t* __restrict__ table, const int32_t* __restrict__ tpos,
                     const float* __restrict__ scores, const float* __restrict__ stats,
                     double* __restrict__ part, int* __restrict__ done, T* __restrict__ out,
                     int Tq, int H, int KV, int PS, int W, int CW, int NS, int bf16sm) {
  constexpr int HD = 32 * EPL;
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = H / KV, GT = G * Tq, S = W * PS, CP = CW * PS;
  const int s_end = live_end(tpos + (size_t)b * Tq, Tq, S);
  const int c0 = sp * CP;
  if (c0 >= s_end) return;
  const int c1 = min(c0 + CP, s_end), n = c1 - c0;
  const int nlive = (s_end + CP - 1) / CP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float neg = bf16sm ? rnd_bf(NEG_INF) : NEG_INF;  // the masked score

  double* red = reinterpret_cast<double*>(smem);       // [NWARPS][RC][HD]
  float* ml_s = reinterpret_cast<float*>(red + NWARPS * RC * HD);  // [2][GT] max, sum
  float* p_s = ml_s + 2 * GT;                           // [GT][CP] this chunk
  int* pg_s = reinterpret_cast<int*>(p_s + GT * CP);    // [CW] this chunk's pages

  // a warp per query row, its lanes over the live chunks: the loads go out
  // together, and the butterflies sum in a fixed order
  const float* st = stats + ((size_t)b * KV + kvh) * NS * GT;
  const float* sc_g = scores + ((size_t)b * KV + kvh) * GT * S;
  for (int r = warp; r < GT; r += NWARPS) {
    float m = neg;
    for (int j = lane; j < nlive; j += 32) m = fmaxf(m, st[(size_t)j * GT + r]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    // every exp(x - max) of the row's live positions, read back from the
    // workspace and summed in float64, then rounded once as the plain sum is
    double L = 0.0;
    for (int s = lane; s < s_end; s += 32)
      L += (double)softmax_exp(sc_g[(size_t)r * S + s], m, bf16sm);
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(FULL, L, o);
    float Lf = (float)L;
    if (bf16sm) Lf = rnd_bf(Lf);
    if (lane == 0) {
      ml_s[r] = m;
      ml_s[GT + r] = Lf;
    }
  }
  for (int i = tid; i < CW && sp * CW + i < W; i += THREADS)
    pg_s[i] = table[(size_t)b * W + sp * CW + i];
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < GT * n; i += THREADS) {
    const int r = i / n, s = i % n;
    const float e = softmax_exp(sc_g[(size_t)r * S + c0 + s], ml_s[r], bf16sm);
    p_s[r * CP + s] =
        bf16sm ? rnd<T>(rnd_bf(e / ml_s[GT + r])) : rnd<T>(e / ml_s[GT + r]);
  }
  __syncthreads();
  // V row of position s (page slot, this KV head); c0 is page-aligned
  auto row_of = [&](int s) {
    return ((size_t)pg_s[(s - c0) / PS] * PS + s % PS) * KV + kvh;
  };

  // output element (query row r, d) of this (row, KV head)
  auto out_at = [&](int r, int d) -> T& {
    return out[(((size_t)b * Tq + r % Tq) * H + kvh * G + r / Tq) * HD + d];
  };
  double* const p0 = part + ((size_t)b * KV + kvh) * NS * GT * HD;
  double* const pt = p0 + (size_t)sp * GT * HD;

  // RC query rows at a time: per-warp partials over its positions, then a
  // fixed-order sum of the warps through shared memory
  for (int r0 = 0; r0 < GT; r0 += RC) {
    double acc[RC][EPL];
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[i][j] = 0.0;
    for (int s0 = c0 + warp * U; s0 < c1; s0 += NWARPS * U) {
      float vr[U][EPL];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < c1) load_kv<T, EPL, KF>(vpool, vscale, row_of(s0 + u), lane, vr[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u >= c1) break;
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          const double p = r0 + i < GT ? p_s[(r0 + i) * CP + s0 + u - c0] : 0.f;
#pragma unroll
          for (int j = 0; j < EPL; ++j) acc[i][j] = fma(p, (double)vr[u][j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < EPL; ++j) red[(warp * RC + i) * HD + lane * EPL + j] = acc[i][j];
    __syncthreads();
    for (int idx = tid; idx < RC * HD; idx += THREADS) {
      const int i = idx / HD, d = idx % HD;
      if (r0 + i < GT) {
        double o = 0.0;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) o += red[(w * RC + i) * HD + d];
        if (nlive == 1)
          out_at(r0 + i, d) = from_f<T>((float)o);
        else
          pt[(size_t)(r0 + i) * HD + d] = o;
      }
    }
    __syncthreads();
  }
  if (nlive == 1) return;

  // every thread's partial is visible before the count moves; the block that
  // moves it last reads the other blocks' partials from L2.  The flag takes
  // the first word of the (free) reduction buffer: a static __shared__ would
  // push the kernel past the 227 KB the dynamic limit is raised to.
  int* last = reinterpret_cast<int*>(red);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(done + (size_t)b * KV + kvh, 1) == nlive - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // two elements per thread (HD % 2 == 0, so one query row), eight chunks'
  // loads in flight: one block reads nlive * G*Tq * HD doubles here
  const double2* p2 = reinterpret_cast<const double2*>(p0);
  const size_t stride2 = (size_t)GT * HD / 2;
  for (int i = tid; i < GT * HD / 2; i += THREADS) {
    double2 o = make_double2(0.0, 0.0);
#pragma unroll 8
    for (int j = 0; j < nlive; ++j) {
      const double2 x = __ldcg(p2 + j * stride2 + i);
      o.x += x.x; o.y += x.y;
    }
    const int r = 2 * i / HD, d = 2 * i % HD;
    out_at(r, d) = from_f<T>((float)o.x);
    out_at(r, d + 1) = from_f<T>((float)o.y);
  }
}

// The two launches of one read, each adding one to *launched once it is
// queued.  workspace: float64 partials [B, KV, NS, G*Tq, HD], then float32
// scores [B, KV, G*Tq, W*PS], then float32 chunk maxima [B, KV, NS, G*Tq],
// then int32 counters [B, KV].
template <typename T, int EPL, int KF>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* table, const void* tpos, void* out, void* workspace, int B, int Tq,
           int H, int KV, int PS, int W, int CW, int NS, float div, int additive,
           int bf16sm, int smem_bytes, void* stream, int* launched) {
  constexpr int HD = 32 * EPL;
  const int GT = H / KV * Tq;
  double* part = static_cast<double*>(workspace);
  float* scores = reinterpret_cast<float*>(part + (size_t)B * KV * NS * GT * HD);
  float* stats = scores + (size_t)B * KV * GT * W * PS;
  int* done = reinterpret_cast<int*>(stats + (size_t)B * KV * NS * GT);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the kernels' dynamic shared-memory limit, raised to the most any plan
  // takes once per device (a bit each), not on every read
  static std::atomic<unsigned> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !((raised.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(paged_attn_score_kernel<T, EPL, KF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(paged_attn_pv_kernel<T, EPL, KF>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised.fetch_or(1u << dev);
  }
  const dim3 grid(KV, B, NS);
  paged_attn_score_kernel<T, EPL, KF><<<grid, THREADS, smem_bytes, st>>>(
      (const T*)q, k, (const __half*)ks, (const int32_t*)table, (const int32_t*)tpos,
      scores, stats, done, Tq, H, KV, PS, W, CW, NS, div, additive, bf16sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  paged_attn_pv_kernel<T, EPL, KF><<<grid, THREADS, smem_bytes, st>>>(
      v, (const __half*)vs, (const int32_t*)table, (const int32_t*)tpos, scores, stats,
      part, done, (T*)out, Tq, H, KV, PS, W, CW, NS, bf16sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

template <typename T, int KF>
int launch_hd(const void* q, const void* k, const void* v, const void* ks, const void* vs,
              const void* table, const void* tpos, void* out, void* workspace, int B,
              int Tq, int H, int KV, int HD, int PS, int W, int CW, int NS, float div,
              int additive, int bf16sm, int smem_bytes, void* stream, int* launched) {
#define PA_CASE(E)                                                                     \
  case E:                                                                              \
    return launch<T, E, KF>(q, k, v, ks, vs, table, tpos, out, workspace, B, Tq, H,    \
                            KV, PS, W, CW, NS, div, additive, bf16sm, smem_bytes,  \
                            stream, launched);
  // the head widths a registered config serves (the LUT-serving model's 64,
  // qwen3-8b's 128); widen the set when a config needs another
  switch (HD / 32) {
    PA_CASE(2) PA_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

template <typename T>
int launch_fmt(int kv_fmt, const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* table, const void* tpos, void* out,
               void* workspace, int B, int Tq, int H, int KV, int HD, int PS, int W,
               int CW, int NS, float div, int additive, int bf16sm, int smem_bytes,
               void* stream, int* launched) {
#define PA_FMT(F)                                                                      \
  case F:                                                                              \
    return launch_hd<T, F>(q, k, v, ks, vs, table, tpos, out, workspace, B, Tq, H, KV, \
                           HD, PS, W, CW, NS, div, additive, bf16sm, smem_bytes,    \
                           stream, launched);
  switch (kv_fmt) {
    PA_FMT(KV_FP) PA_FMT(KV_I8) PA_FMT(KV_I4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_FMT
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (of q and out).  HD: 64 or 128.  kv_fmt: 0
// fp pools [P,PS,KV,HD] of that dtype; 1 int8 codes [P,PS,KV,HD]; 2 int4 codes
// [P,PS,KV,HD/2] (HD % 64 == 0); quantized pools with float16 scales
// ks / vs [P,PS,KV,1], null for fp.  q [B,Tq,H,HD], table int32 [B,W], tpos
// int32 [B,Tq], out [B,Tq,H,HD], all contiguous and 16-byte aligned.  The
// positions of a row are split into NS chunks of CW pages (NS = ceil(W / CW));
// workspace: 4-byte words, B*KV*(G*Tq*(NS*(2*HD + 1) + W*PS) + 1) of them,
// 16-byte aligned; smem_bytes: dynamic shared memory of the score and PV
// launches (at most 227 KB).  bf16_softmax: 1 runs the bfloat16 score
// pipeline, 0 the float32 one.  Adds the CUDA launches it queued to *launched.
int paged_attention_run(int dtype, int kv_fmt, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs, const void* table,
                        const void* tpos, void* out, void* workspace, int B, int Tq, int H,
                        int KV, int HD, int PS, int W, int CW, int NS, float div,
                        int additive, int bf16_softmax, int smem_bytes, void* stream,
                        int* launched) {
  if (B <= 0 || Tq <= 0 || KV <= 0 || H % KV != 0 || (HD != 64 && HD != 128) ||
      PS <= 0 || W <= 0 || CW <= 0 || NS != (W + CW - 1) / CW || workspace == nullptr ||
      smem_bytes > SMEM_MAX || launched == nullptr ||
      (kv_fmt != KV_FP && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_fmt<float>(kv_fmt, q, k, v, ks, vs, table, tpos, out, workspace, B, Tq,
                               H, KV, HD, PS, W, CW, NS, div, additive, bf16_softmax,
                               smem_bytes, stream, launched);
    case 1:
      return launch_fmt<__nv_bfloat16>(kv_fmt, q, k, v, ks, vs, table, tpos, out,
                                       workspace, B, Tq, H, KV, HD, PS, W, CW, NS, div,
                                       additive, bf16_softmax, smem_bytes, stream, launched);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
