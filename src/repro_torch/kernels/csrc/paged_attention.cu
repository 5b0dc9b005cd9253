// Paged-attention read over fp, int8 or packed-int4 pages for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// _paged_attn_kernel (driven by paged_attention), both its fp branch and its
// quantized branch (kv_fmt != "fp").
//
// Computes, for every batch row b and KV head kv, the grouped-GQA attention
// of its G = H / KV query heads over the pages its page table names:
// scores[g, t, s] = (q[b, t, kv*G+g] . k[page(s), s % ps, kv]) rounded to the
// input dtype, divided by sqrt(hd) (itself rounded to the input dtype) and
// rounded again, masked to -1e30 where s > tpos[b, t] (where- or additive
// form), then softmax in float32 as exp(x - max) / sum, probabilities rounded
// to the input dtype, and the PV sum rounded to the input dtype.  Every
// rounding is the one the gather read (models/attention.paged_gather_read)
// performs, so the two differ only by float32 summation order.
//
// Quantized pages hold int8 codes [.., hd], or two int4 codes per byte
// [.., hd/2] (element 2i in the low nibble, sign-extended), beside one
// float16 scale per (page slot, KV head) [.., 1] that rides the same table
// walk.  A lane dequantizes its codes in registers with exactly the plain
// formula codes.to(T) * scale.to(T): the f16 scale is rounded to T (f16 ->
// f32 -> T, round to nearest even), then the product is rounded to T.  So
// every dequantized element equals the plain read's, and the scores and PV
// sums are those of fp pages holding the dequantized values.
//
// Design.  One block of 8 warps per (KV head, batch row).  The TPU kernel's
// scalar prefetch and sequential page grid do not carry over: the block reads
// its own row of the page table into shared memory and addresses K/V rows
// through it.  Positions past the largest tpos of the block are masked for
// every one of its query rows: their probabilities are exactly 0, so the
// block neither loads nor scores them (the plain read adds those zeros).
// Scores: warps take U key positions at a time and load all U K rows before
// any arithmetic (each lane one vector of head_dim/32 elements, a warp one
// coalesced row), then for 8 query rows at a time a transposing butterfly
// reduces the 8 lane-partial dots in 9 shuffles.  Exp and normalise are
// deferred until every position has been scored, as in the TPU kernel (no
// online rescale), so the roundings match the plain version's.  Scores live
// in shared memory when G*T*S floats fit beside q, else in a float32 scratch
// tensor the wrapper allocates.  PV: the warps split the positions again,
// each lane accumulates its head_dim/32 output elements for 8 query rows over
// U V rows loaded at once, and the 8 warp partials are summed in a fixed
// order through shared memory.
//
// What bounds it on this card.  At decode (T = 1) the work is about
// 4*H*S*hd flops against 2*S*kv*hd*2 bytes of K and V per row: G = 4 flops
// per byte, so the K/V page stream bounds it (3.35 TB/s).  Each live page is
// read from device memory once per block, pages the table does not name are
// never touched, and no gathered [B, S, kv, hd] view is materialised.  With
// one block per (KV head, row) a decode step fills only B*KV SMs, so the
// loads in flight per SM (U rows per warp) set the rate.  Quantized pages
// move hd bytes (int8) or hd/2 bytes (int4) per row plus a 2-byte scale, a
// half and a quarter of the bf16 bytes: each lane loads its hd/32 codes in one
// vector, so a warp still reads a row in one coalesced transaction.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int RC = 8;  // query rows per reduction / accumulation chunk
constexpr int U = 8;   // key positions whose rows a warp loads at once
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

template <int N>
__device__ __forceinline__ void sts_f(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = v[j];
  }
}

// Sum each of v[0..7] over the 32 lanes of the warp.  A transposing
// butterfly: every exchange halves the rows a lane carries, so 9 shuffles
// replace 40.  Lane l ends with the total of row lane_row(l).
__device__ __forceinline__ float reduce8(float (&v)[RC], int lane) {
  {
    const bool up = lane & 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = up ? v[i] : v[i + 4];
      const float keep = up ? v[i + 4] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up ? v[i] : v[i + 2];
      const float keep = up ? v[i + 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, 8);
    }
  }
  {
    const bool up = lane & 4;
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  v[0] += __shfl_xor_sync(FULL, v[0], 2);
  v[0] += __shfl_xor_sync(FULL, v[0], 1);
  return v[0];
}

__device__ __forceinline__ int lane_row(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// EPL: head_dim / 32 elements per lane; KF: page format (KV_FP pools hold
// T, quantized pools int8 codes with float16 scales kscale / vscale)
template <typename T, int EPL, int KF>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const void* __restrict__ kpool,
                  const void* __restrict__ vpool, const __half* __restrict__ kscale,
                  const __half* __restrict__ vscale, const int32_t* __restrict__ table,
                  const int32_t* __restrict__ tpos, T* __restrict__ out,
                  float* __restrict__ scratch, int Tq, int H, int KV, int PS, int W,
                  float div, int additive) {
  constexpr int HD = 32 * EPL;
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int GT = G * Tq;
  const int S = W * PS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  float* q_s = smem;                                          // [GT][HD]
  float* red = q_s + GT * HD;                                 // [NWARPS][RC][HD]
  int* tp_s = reinterpret_cast<int*>(red + NWARPS * RC * HD); // [Tq]
  int* pg_s = tp_s + Tq;                                      // [W] this row's pages
  float* sc = scratch != nullptr
                  ? scratch + ((size_t)b * KV + kvh) * GT * S
                  : reinterpret_cast<float*>(pg_s + W);         // [GT][S]

  for (int i = tid; i < GT * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int g = r / Tq, t = r % Tq;
    q_s[i] = to_f<T>(q[(((size_t)b * Tq + t) * H + kvh * G + g) * HD + d]);
  }
  for (int i = tid; i < Tq; i += THREADS) tp_s[i] = tpos[(size_t)b * Tq + i];
  for (int i = tid; i < W; i += THREADS) pg_s[i] = table[(size_t)b * W + i];
  __syncthreads();

  // live positions: [0, s_end).  If every row is masked everywhere (no tpos
  // >= 0) the plain softmax is uniform over all S, so nothing is skipped.
  int tmax = -1;
  for (int t = 0; t < Tq; ++t) tmax = max(tmax, tp_s[t]);
  const int s_end = tmax >= 0 ? min(S, tmax + 1) : S;
  // K/V row of position s: (page slot, this KV head)
  auto row_of = [&](int s) {
    return ((size_t)pg_s[s / PS] * PS + s % PS) * KV + kvh;
  };

  // scores
  for (int s0 = warp * U; s0 < s_end; s0 += NWARPS * U) {
    float kr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < s_end) {
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
        float part[RC];
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          part[i] = 0.f;
#pragma unroll
          for (int j = 0; j < EPL; ++j) part[i] = fmaf(qr[i][j], kr[u][j], part[i]);
        }
        const float dot = reduce8(part, lane);
        const int s = s0 + u;
        if ((lane & 3) == 0 && r < GT && s < s_end) {
          float v = rnd<T>(rnd<T>(dot) / div);
          const bool valid = s <= tp_s[r % Tq];
          if (additive)
            v = v + (valid ? 0.f : NEG_INF);
          else
            v = valid ? v : NEG_INF;
          sc[(size_t)r * S + s] = v;
        }
      }
    }
  }
  __syncthreads();

  // deferred softmax over the live positions: exp(x - max) / sum,
  // probabilities rounded to T
  for (int r = warp; r < GT; r += NWARPS) {
    float* row = sc + (size_t)r * S;
    float m = NEG_INF;
    for (int s = lane; s < s_end; s += 32) m = fmaxf(m, row[s]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    float sum = 0.f;
    for (int s = lane; s < s_end; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    for (int s = lane; s < s_end; s += 32) row[s] = rnd<T>(row[s] / sum);
  }
  __syncthreads();

  // PV, RC query rows at a time: per-warp partials over its positions, then
  // a fixed-order sum of the warps through shared memory
  for (int r0 = 0; r0 < GT; r0 += RC) {
    float acc[RC][EPL];
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[i][j] = 0.f;
    for (int s0 = warp * U; s0 < s_end; s0 += NWARPS * U) {
      float vr[U][EPL];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < s_end) load_kv<T, EPL, KF>(vpool, vscale, row_of(s0 + u), lane, vr[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u >= s_end) break;
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          const float p = r0 + i < GT ? sc[(size_t)(r0 + i) * S + s0 + u] : 0.f;
#pragma unroll
          for (int j = 0; j < EPL; ++j) acc[i][j] = fmaf(p, vr[u][j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RC; ++i) sts_f<EPL>(red + (warp * RC + i) * HD + lane * EPL, acc[i]);
    __syncthreads();
    for (int idx = tid; idx < RC * HD; idx += THREADS) {
      const int i = idx / HD, d = idx % HD;
      const int r = r0 + i;
      if (r < GT) {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) o += red[(w * RC + i) * HD + d];
        const int g = r / Tq, t = r % Tq;
        out[(((size_t)b * Tq + t) * H + kvh * G + g) * HD + d] = from_f<T>(o);
      }
    }
    __syncthreads();
  }
}

template <typename T, int EPL, int KF>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* table, const void* tpos, void* out, void* scratch, int B, int Tq,
           int H, int KV, int PS, int W, float div, int additive, int smem_bytes,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(paged_attn_kernel<T, EPL, KF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  paged_attn_kernel<T, EPL, KF><<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const T*)q, k, v, (const __half*)ks, (const __half*)vs, (const int32_t*)table,
      (const int32_t*)tpos, (T*)out, (float*)scratch, Tq, H, KV, PS, W, div, additive);
  return (int)cudaGetLastError();
}

template <typename T, int KF>
int launch_hd(const void* q, const void* k, const void* v, const void* ks, const void* vs,
              const void* table, const void* tpos, void* out, void* scratch, int B, int Tq,
              int H, int KV, int HD, int PS, int W, float div, int additive,
              int smem_bytes, void* stream) {
#define PA_CASE(E)                                                                      \
  case E:                                                                               \
    return launch<T, E, KF>(q, k, v, ks, vs, table, tpos, out, scratch, B, Tq, H, KV,   \
                            PS, W, div, additive, smem_bytes, stream);
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
               void* scratch, int B, int Tq, int H, int KV, int HD, int PS, int W,
               float div, int additive, int smem_bytes, void* stream) {
  switch (kv_fmt) {
    case KV_FP:
      return launch_hd<T, KV_FP>(q, k, v, ks, vs, table, tpos, out, scratch, B, Tq, H,
                                 KV, HD, PS, W, div, additive, smem_bytes, stream);
    case KV_I8:
      return launch_hd<T, KV_I8>(q, k, v, ks, vs, table, tpos, out, scratch, B, Tq, H,
                                 KV, HD, PS, W, div, additive, smem_bytes, stream);
    case KV_I4:
      return launch_hd<T, KV_I4>(q, k, v, ks, vs, table, tpos, out, scratch, B, Tq, H,
                                 KV, HD, PS, W, div, additive, smem_bytes, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (of q and out).  HD: 64 or 128.  kv_fmt: 0
// fp pools [P,PS,KV,HD] of that dtype; 1 int8 codes [P,PS,KV,HD]; 2 int4 codes
// [P,PS,KV,HD/2] (HD % 64 == 0); quantized pools with float16 scales
// ks / vs [P,PS,KV,1], null for fp.  q [B,Tq,H,HD], table int32 [B,W], tpos
// int32 [B,Tq], out [B,Tq,H,HD], all contiguous and 16-byte aligned.
// scratch: float32 [B,KV,G*Tq,W*PS], or null to keep the scores in shared
// memory (smem_bytes then includes them).
int paged_attention_run(int dtype, int kv_fmt, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs, const void* table,
                        const void* tpos, void* out, void* scratch, int B, int Tq, int H,
                        int KV, int HD, int PS, int W, float div, int additive,
                        int smem_bytes, void* stream) {
  if (B <= 0 || Tq <= 0 || KV <= 0 || H % KV != 0 || (HD != 64 && HD != 128) ||
      PS <= 0 || W <= 0 || (kv_fmt != KV_FP && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_fmt<float>(kv_fmt, q, k, v, ks, vs, table, tpos, out, scratch, B, Tq,
                               H, KV, HD, PS, W, div, additive, smem_bytes, stream);
    case 1:
      return launch_fmt<__nv_bfloat16>(kv_fmt, q, k, v, ks, vs, table, tpos, out, scratch,
                                       B, Tq, H, KV, HD, PS, W, div, additive, smem_bytes,
                                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
