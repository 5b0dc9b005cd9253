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
// walk.  Codes are staged raw and dequantized on their way out of shared
// memory with exactly the plain formula codes.to(T) * scale.to(T): the f16
// scale is rounded to T (f16 -> f32 -> T, round to nearest even), then the
// product is rounded to T.  So every dequantized element equals the plain
// read's.
//
// What bounds it on this card.  Not bytes or operations: at a qwen3-8b
// decode step (B = 4, W = 17) the read moves 2.4 MB (0.7 us at 3.35 TB/s)
// and needs ~35 MFLOP of float64 FMA (~1 us).  What costs is the chain of
// dependent steps each (KV head, row) walks: its page table, then its K and
// V rows, then a softmax whose max and sum span the whole row, then a sum of
// the row's PV partials.  The design keeps that chain short and on chip:
//   - One launch per read over a grid of (NS, KV, B) blocks, the NS chunks of
//     one (KV head, row) forming one thread-block cluster (NS <= 8, the
//     portable size).  A chunk is CW whole pages; the wrapper fixes NS and
//     CW from the table width, the page size, the KV heads and the SM count,
//     never from the batch, T or tpos, so a row's sums round the same in
//     any call.  The row's
//     max, its exp-sum and its PV partials cross between the chunks through
//     distributed shared memory, phases apart by cluster barriers: no
//     workspace, counter or atomic in device memory.
//   - A block stages its chunk's K and V rows with cp.async, 16 bytes a
//     thread, in tiles of TP positions, two tiles of each in flight before
//     any arithmetic: a decode chunk's V arrives while it scores.
//   - Both products run on the float64 tensor cores (mma.sync m16n8k4 f64,
//     DMMA): scores = Q[G*T x hd] . K^T over 16-row blocks of query rows and
//     8-position blocks, PV = P[G*T x chunk] . V[chunk x hd].  bf16 and f32
//     operands widen to float64 exactly and DMMA accumulates in float64, so
//     each sum is the one the plain read rounds.  Each output element's
//     chain depends only on its own row and column, so a query reads the
//     same bits whatever rows ride beside it.
// What is left, as tools/attention_phases.py times it on an H100: a decode
// read is a chain of about a dozen phases of 0.5-3 us each (a fifth of it
// fetching code the launch runs once); at T = 16 the products bound it, as
// each operand widened to float64 (F2F) takes the same FP64 pipe as the
// DMMAs.  m16n8k4 does twice the m8n8k4's work per instruction (66 against
// 33 TFLOP/s on that card).
// Phases of one block (chunk sp of a (KV head, row)):
//   (a) load the chunk's page numbers, the row's tpos and its G*T query rows
//       (as float, rows padded to 16 with zeros); stage K and V tiles; score
//       each K tile into the chunk's score buffer; the chunk's max per query
//       row.                                                  cluster.sync
//   (b) the row max m over the NS chunk maxima (each block pushes its
//       maxima into every peer's shared memory before the barrier); the
//       chunk's exp(x - m) in place of x, and their float64 sum, pushed
//       the same way.                                         cluster.sync
//   (c) L = the NS chunk sums added in chunk order, rounded to float32 (and
//       to bfloat16 under that pipeline): every block gets the same L; p =
//       rnd_T(exp(x - m) / L) in place; the chunk's float64 PV partial in
//       shared memory (it reuses q's and K's space).          cluster.sync
//   (d) each block sums its slice of the G*T x hd outputs over the NS
//       partials in chunk order, rounds to T and writes it.   cluster.sync
// (the last barrier keeps every block's shared memory alive until its peers
// have read it).  The score buffer is the chunk's G*T x CW*ps float32 scores
// in shared memory; where they do not fit beside the staged tiles (a long
// table at a prefill width) the wrapper hands a scratch area, one slice per
// block, that only the block that writes it reads, in the same launch.
// Positions past the largest tpos of the row are masked for all its
// queries: their probabilities are exactly 0, so no block stages or scores
// them, and a chunk wholly past that end contributes max -1e30, sum 0 and a
// zero partial.  If no tpos of the row is >= 0 every query is masked
// everywhere and the plain softmax is uniform over all S, so nothing is
// skipped.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int NBUF = 2;   // tiles of K and of V staged at once
constexpr int RG = 2;     // 16-row blocks of query rows a warp carries at once
constexpr int NS_MAX = 8;  // chunks of a row: the portable cluster size
constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may take
enum : int { KV_FP = 0, KV_I8 = 1, KV_I4 = 2 };  // page formats

// Staging geometry of one instance.  RB: bytes of one (slot, head) K/V row in
// the pool; TP: positions per staged tile (about 8 KB of rows); KLD / VLD:
// staged row strides, padded so the MMA fragments' loads hit distinct banks;
// QLD (floats) and PLD (doubles): strides of the query rows and the partial.
template <typename T, int HD, int KF>
struct Geo {
  static constexpr int RB = KF == KV_FP ? HD * (int)sizeof(T) : KF == KV_I8 ? HD : HD / 2;
  static constexpr int TP = 8192 / RB < 64 ? 8192 / RB : 64;
  static constexpr int KLD = RB + 16, VLD = RB + 32;
  static constexpr int QLD = HD + 4, PLD = HD + 8;
  static constexpr int SCB = KF == KV_FP ? 0 : NBUF * TP * 4;  // float scale per row
  static constexpr int KRING = NBUF * TP * KLD, VRING = NBUF * TP * VLD;
};

// Byte offsets of a block's shared memory (the wrapper's block_smem mirrors
// them): [q rows | K tiles | K scales] overlaid by the PV partial, then [V
// tiles | V scales], the NS chunks' row maxima and sums, the row sums L, the
// chunk's pages and tpos, then the score buffer when it lives here.
struct Layout {
  int v, small, scores, total;
};

template <typename T, int HD, int KF>
__host__ __device__ inline Layout layout(int GTP, int CW, int Tq, int SLD, bool scores_here) {
  using L = Geo<T, HD, KF>;
  const int qk = GTP * L::QLD * 4 + L::KRING + L::SCB, part = GTP * L::PLD * 8;
  Layout o;
  o.v = qk > part ? qk : part;
  o.small = o.v + L::VRING + L::SCB;
  o.scores = o.small + ((GTP * (NS_MAX * 12 + 4) + 4 * (CW + Tq) + 15) & ~15);
  o.total = o.scores + (scores_here ? GTP * SLD * 4 : 0);
  return o;
}

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

// a nibble as a sign-extended 4-bit integer
__device__ __forceinline__ int sext4(unsigned x) { return (int)(x << 28) >> 28; }

// Element d of a staged K/V row as float64.  Quantized formats dequantize
// exactly as the plain read does: codes.to(T) * scale.to(T), with both
// roundings to T (s is the row's scale, already rounded to T).
template <typename T, int KF>
__device__ __forceinline__ double kv_elem(const uint8_t* row, int d, float s) {
  if constexpr (KF == KV_FP) {
    return (double)to_f<T>(reinterpret_cast<const T*>(row)[d]);
  } else if constexpr (KF == KV_I8) {
    return (double)rnd<T>((float)(int8_t)row[d] * s);
  } else {
    const unsigned byte = row[d >> 1];
    return (double)rnd<T>((float)sext4(d & 1 ? byte >> 4 : byte & 0xfu) * s);
  }
}

// D[16x8] += A[16x4] . B[4x8] in float64 on the tensor cores (DMMA).  Lane
// l holds A[l/4][l%4] and A[l/4 + 8][l%4], B[l%4][l/4], and D[l/4][2(l%4)
// + {0, 1}] then D[l/4 + 8][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Scores of R 16-row blocks of query rows (q: the first one's first row)
// against one 8-position block of staged K (krow: lane l's row, position
// l/4 of the block): acc[j][c] sums the k-steps of parity c, two chains so
// that one DMMA's latency hides behind the other's.  R is a template
// argument so that the loop holds no branch: its loads and DMMAs overlap.
// HALF: the last block's upper 8 rows are all padding, and are fed zeros.
template <int R, bool HALF, typename T, int HD, int KF>
__device__ __forceinline__ void score_blocks(const float* q, const uint8_t* krow, float ks,
                                             int lane, double (&acc)[RG][2][4]) {
  constexpr int QLD = HD + 4;
  const float* qr = q + (lane >> 2) * QLD + (lane & 3);
#pragma unroll 2
  for (int k0 = 0; k0 < HD; k0 += 8) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = k0 + 4 * c;
      const double bk = kv_elem<T, KF>(krow, k + (lane & 3), ks);
#pragma unroll
      for (int j = 0; j < R; ++j)
        dmma(acc[j][c], qr[j * 16 * QLD + k],
             HALF && j == R - 1 ? 0.0 : (double)qr[(j * 16 + 8) * QLD + k], bk);
    }
  }
}

// PV of R 16-row blocks of probabilities (p: the first one's first row, at
// the tile's first position; row stride sld) over a staged V tile, into two
// 8-column blocks of the output: lane l's B columns are d and d + 8 (d =
// the first block's column l/4), acc[j][e] the j-th row block's sum over
// column block e (two independent chains); nks k-steps of 4 positions (the
// rows and columns past the tile's positions hold zeros).  Each converted V
// element serves R DMMAs, each converted P element two.  HALF as in
// score_blocks.
template <int R, bool HALF, typename T, int KF>
__device__ __forceinline__ void pv_blocks(const float* p, int sld, const uint8_t* vt, int vld,
                                          const float* vs, int d, int nks, int lane,
                                          double (&acc)[RG][2][4]) {
  const float* pr = p + (lane >> 2) * sld + (lane & 3);
#pragma unroll 2
  for (int k = 0; k < nks; ++k) {
    const int pos = k * 4 + (lane & 3);
    const uint8_t* vrow = vt + pos * vld;
    const float s = KF == KV_FP ? 0.f : vs[pos];
    const double b0 = kv_elem<T, KF>(vrow, d, s), b1 = kv_elem<T, KF>(vrow, d + 8, s);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const double a0 = pr[j * 16 * sld + k * 4];
      const double a1 = HALF && j == R - 1 ? 0.0 : (double)pr[(j * 16 + 8) * sld + k * 4];
      dmma(acc[j][0], a0, a1, b0);
      dmma(acc[j][1], a0, a1, b1);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's cp.async groups are in flight (n is
// capped at 3: waiting for more than needed is only slower)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// End of the live positions of a batch row, [0, s_end): past its largest
// tpos every query is masked.  If no tpos >= 0, every query is masked
// everywhere and the plain softmax is uniform over all S.
__device__ __forceinline__ int live_end(const int* tp, int Tq, int S) {
  int tmax = -1;
  for (int t = 0; t < Tq; ++t) tmax = max(tmax, tp[t]);
  return tmax >= 0 ? min(S, tmax + 1) : S;
}

// One read: block (sp, kvh, b) takes chunk sp of KV head kvh of batch row b;
// the NS = gridDim.x chunks of a (KV head, row) are one cluster (block rank
// sp).  scratch: null when the score buffer lives in shared memory, else
// float32 [B, KV, NS, GTP, SLD], each block's slice its own.
template <typename T, int HD, int KF>
__global__ void __launch_bounds__(THREADS, 2)
paged_attn_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kpool,
                  const uint8_t* __restrict__ vpool, const __half* __restrict__ kscale,
                  const __half* __restrict__ vscale, const int32_t* __restrict__ table,
                  const int32_t* __restrict__ tpos, T* __restrict__ out,
                  float* __restrict__ scratch, int Tq, int H, int KV, int PS, int W, int CW,
                  float div, int additive, int bf16sm) {
  using L = Geo<T, HD, KF>;
  constexpr int TP = L::TP;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, NS = gridDim.x;
  const int G = H / KV, GT = G * Tq, GTP = (GT + 15) & ~15, S = W * PS, CP = CW * PS;
  const int SLD = ((CP + 31) & ~31) + 4;  // 4 mod 32: P's fragment loads miss no bank
  // 16-row blocks of query rows; the last one's upper half is padding when
  // GT % 16 is 1..8
  const int nrb = GTP >> 4, nrg = (nrb + RG - 1) / RG;
  const bool half = GT + 8 <= GTP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float neg = bf16sm ? rnd_bf(NEG_INF) : NEG_INF;  // the masked score

  const Layout lay = layout<T, HD, KF>(GTP, CW, Tq, SLD, scratch == nullptr);
  float* q_s = reinterpret_cast<float*>(smem);                        // [GTP][QLD]
  uint8_t* k_s = smem + GTP * L::QLD * 4;                              // [NBUF][TP][KLD]
  float* ksc_s = reinterpret_cast<float*>(k_s + L::KRING);             // [NBUF][TP]
  double* part = reinterpret_cast<double*>(smem);                      // [GTP][PLD], phase (c)
  uint8_t* v_s = smem + lay.v;                                         // [NBUF][TP][VLD]
  float* vsc_s = reinterpret_cast<float*>(v_s + L::VRING);             // [NBUF][TP]
  double* ls_all = reinterpret_cast<double*>(smem + lay.small);      // [NS][GTP] sums
  float* mx_all = reinterpret_cast<float*>(ls_all + NS_MAX * GTP);     // [NS][GTP] maxima
  float* l_s = mx_all + NS_MAX * GTP;                                  // [GTP] row sum L
  int* pg_s = reinterpret_cast<int*>(l_s + GTP);                       // [CW] pages
  int* tp_s = pg_s + CW;                                               // [Tq]
  float* sc = scratch ? scratch + (((size_t)b * KV + kvh) * NS + sp) * GTP * SLD
                      : reinterpret_cast<float*>(smem + lay.scores);   // [GTP][SLD]

  // (a) the chunk's pages, the row's tpos and its query rows (zero past GT)
  for (int i = tid; i < CW; i += THREADS) {
    const int p = sp * CW + i;
    pg_s[i] = p < W ? __ldg(table + (size_t)b * W + p) : 0;
  }
  for (int i = tid; i < Tq; i += THREADS) tp_s[i] = __ldg(tpos + (size_t)b * Tq + i);
  constexpr int QV = 16 / (int)sizeof(T);  // elements per 16-byte load
  for (int i = tid; i < GTP * (HD / QV); i += THREADS) {
    const int r = i / (HD / QV), c = i % (HD / QV) * QV;
    float* dst = q_s + r * L::QLD + c;
    if (r < GT) {
      const int g = r / Tq, t = r % Tq;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * Tq + t) * H + kvh * G + g) * HD + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < QV; ++j) dst[j] = to_f<T>(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < QV; ++j) dst[j] = 0.f;
    }
  }
  __syncthreads();
  const int s_end = live_end(tp_s, Tq, S);
  const int c0 = sp * CP;
  const int n = max(0, min(c0 + CP, s_end) - c0);  // live positions of the chunk
  const int nt = (n + TP - 1) / TP;                 // tiles of them

  // Stage tile i of the chunk's K or V rows into its ring slot with
  // cp.async, rows past the tile's positions zeroed up to the next multiple
  // of 4 (the PV k-steps read them); one cp.async group per call.
  auto stage = [&](const uint8_t* pool, const __half* scale, uint8_t* ring, float* sring,
                   int ld, int i) {
    uint8_t* dst = ring + (i % NBUF) * TP * ld;
    float* sdst = sring + (i % NBUF) * TP;
    const int s0 = c0 + i * TP, cnt = max(0, min(TP, n - i * TP));
    auto row_of = [&](int s) {
      return ((size_t)pg_s[(s - c0) / PS] * PS + s % PS) * KV + kvh;
    };
    constexpr int CPR = L::RB / 16;
    for (int j = tid; j < cnt * CPR; j += THREADS) {
      const int r = j / CPR, c = j % CPR;
      cp_async16(dst + r * ld + c * 16, pool + row_of(s0 + r) * L::RB + c * 16);
    }
    if constexpr (KF != KV_FP) {
      for (int r = tid; r < cnt; r += THREADS)
        sdst[r] = rnd<T>(__half2float(scale[row_of(s0 + r)]));
    }
    const int pad = ((cnt + 3) & ~3) - cnt;
    for (int j = tid; j < pad * (L::RB / 4); j += THREADS)
      reinterpret_cast<unsigned*>(dst + (cnt + j / (L::RB / 4)) * ld)[j % (L::RB / 4)] = 0u;
    if constexpr (KF != KV_FP) {
      for (int r = tid; r < pad; r += THREADS) sdst[cnt + r] = 0.f;
    }
    cp_async_commit();
  };

  // the first NBUF tiles of K, then of V: groups 0..NBUF-1 and NBUF..2*NBUF-1
  // (one call site: the kernel's code is fetched once per launch, and every
  // copy of it costs fetch time)
  int committed = 0;
#pragma unroll 1
  for (; committed < 2 * NBUF; ++committed) {
    const bool isv = committed >= NBUF;
    stage(isv ? vpool : kpool, isv ? vscale : kscale, isv ? v_s : k_s, isv ? vsc_s : ksc_s,
          isv ? L::VLD : L::KLD, committed % NBUF);
  }

  for (int i = 0; i < nt; ++i) {
    // K tile i is group i, or NBUF + i once the ring refills
    cp_async_wait(min(committed - (i < NBUF ? i : NBUF + i) - 1, 3));
    __syncthreads();
    const uint8_t* kt = k_s + (i % NBUF) * TP * L::KLD;
    const float* kst = ksc_s + (i % NBUF) * TP;
    const int s0 = i * TP, cnt = min(TP, n - s0), npb = (cnt + 7) >> 3;
    // a warp scores RG 16-row blocks against 8 positions; lane l's B column
    // is position l/4 of the block
    for (int u = warp; u < npb * nrg; u += NWARPS) {
      const int pb = u % npb, rb0 = u / npb * RG;
      const int pr = pb * 8 + (lane >> 2);
      const uint8_t* krow = kt + pr * L::KLD;
      const float ks = KF == KV_FP ? 0.f : kst[pr];
      const float* qr = q_s + rb0 * 16 * L::QLD;
      double acc[RG][2][4] = {};
      switch (min(RG, nrb - rb0) * 2 + (rb0 + RG >= nrb && half)) {
        case 2: score_blocks<1, false, T, HD, KF>(qr, krow, ks, lane, acc); break;
        case 3: score_blocks<1, true, T, HD, KF>(qr, krow, ks, lane, acc); break;
        case 4: score_blocks<2, false, T, HD, KF>(qr, krow, ks, lane, acc); break;
        default: score_blocks<2, true, T, HD, KF>(qr, krow, ks, lane, acc); break;
      }
#pragma unroll
      for (int j = 0; j < RG; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (rb0 + j) * 16 + (e >> 1) * 8 + (lane >> 2);
          const int pos = pb * 8 + (lane & 3) * 2 + (e & 1);
          if (rb0 + j >= nrb || r >= GT || pos >= cnt) continue;
          float v = rnd<T>(rnd<T>((float)(acc[j][0][e] + acc[j][1][e])) / div);
          if (bf16sm) v = rnd_bf(v);
          const bool valid = c0 + s0 + pos <= tp_s[r % Tq];
          if (additive)
            v = v + (valid ? 0.f : neg);
          else
            v = valid ? v : neg;
          if (bf16sm) v = rnd_bf(v);
          sc[r * SLD + s0 + pos] = v;
        }
      }
    }
    __syncthreads();
    if (i + NBUF < nt) {
      stage(kpool, kscale, k_s, ksc_s, L::KLD, i + NBUF);
      ++committed;
    }
  }
  // the chunk's max per query row, starting at the masked value (which a
  // bfloat16 mask rounds below NEG_INF), pushed into every block of the
  // cluster (lane j stores into block j): after the barrier each block
  // reads the NS maxima from its own shared memory
  for (int r = warp; r < GT; r += NWARPS) {
    float m = neg;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sc[r * SLD + i]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    if (lane < NS) cluster.map_shared_rank(mx_all, lane)[sp * GTP + r] = m;
  }
  cluster.sync();

  // (b) the row max over the chunks; exp(x - m) in place and its float64
  // sum, pushed into every block as the maxima were
  for (int r = warp; r < GT; r += NWARPS) {
    float m = neg;
    for (int j = 0; j < NS; ++j) m = fmaxf(m, mx_all[j * GTP + r]);
    double l = 0.0;
    for (int i = lane; i < n; i += 32) {
      const float e = softmax_exp(sc[r * SLD + i], m, bf16sm);
      sc[r * SLD + i] = e;
      l += (double)e;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
    if (lane < NS) cluster.map_shared_rank(ls_all, lane)[sp * GTP + r] = l;
  }
  cluster.sync();

  // (c) L over the chunks in chunk order, rounded once as the plain sum is;
  // probabilities as the plain read rounds them, zero up to the next k-step
  for (int r = tid; r < GT; r += THREADS) {
    double l = 0.0;
    for (int j = 0; j < NS; ++j) l += ls_all[j * GTP + r];
    const float lf = (float)l;
    l_s[r] = bf16sm ? rnd_bf(lf) : lf;
  }
  __syncthreads();
  const int n4 = (n + 3) & ~3;
  for (int r = warp; r < GT; r += NWARPS) {
    const float lf = l_s[r];
    for (int s = lane; s < n4; s += 32) {
      float p = 0.f;
      if (s < n) {
        const float e = sc[r * SLD + s];
        p = bf16sm ? rnd<T>(rnd_bf(e / lf)) : rnd<T>(e / lf);
      }
      sc[r * SLD + s] = p;
    }
  }
  // the partial takes q's and K's space, which the block is done with
  for (int i = tid; i < GTP * L::PLD; i += THREADS) part[i] = 0.0;
  for (int i = 0; i < nt; ++i) {
    // V tile i is group NBUF + i, or follows the K tiles once the ring refills
    cp_async_wait(min(committed - (i < NBUF ? NBUF + i
                                            : 2 * NBUF + max(0, nt - NBUF) + i - NBUF) - 1,
                      3));
    __syncthreads();
    const uint8_t* vt = v_s + (i % NBUF) * TP * L::VLD;
    const float* vst = vsc_s + (i % NBUF) * TP;
    const int s0 = i * TP, nks = (min(TP, n - s0) + 3) >> 2;
    // a warp sums RG 16-row blocks over 16 output columns
    constexpr int NDG = HD / 16;
    for (int u = warp; u < NDG * nrg; u += NWARPS) {
      const int dg = u % NDG, rb0 = u / NDG * RG;
      const int d = dg * 16 + (lane >> 2);
      const float* pr = sc + rb0 * 16 * SLD + s0;
      double acc[RG][2][4] = {};
      switch (min(RG, nrb - rb0) * 2 + (rb0 + RG >= nrb && half)) {
        case 2: pv_blocks<1, false, T, KF>(pr, SLD, vt, L::VLD, vst, d, nks, lane, acc); break;
        case 3: pv_blocks<1, true, T, KF>(pr, SLD, vt, L::VLD, vst, d, nks, lane, acc); break;
        case 4: pv_blocks<2, false, T, KF>(pr, SLD, vt, L::VLD, vst, d, nks, lane, acc); break;
        default: pv_blocks<2, true, T, KF>(pr, SLD, vt, L::VLD, vst, d, nks, lane, acc); break;
      }
#pragma unroll
      for (int j = 0; j < RG; ++j) {
        if (rb0 + j >= nrb) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            double2* p = reinterpret_cast<double2*>(
                part + ((rb0 + j) * 16 + h * 8 + (lane >> 2)) * L::PLD + dg * 16 + e * 8 +
                (lane & 3) * 2);
            double2 x = *p;
            x.x += acc[j][e][2 * h];
            x.y += acc[j][e][2 * h + 1];
            *p = x;
          }
      }
    }
    __syncthreads();
    if (i + NBUF < nt) {
      stage(vpool, vscale, v_s, vsc_s, L::VLD, i + NBUF);
      ++committed;
    }
  }
  cluster.sync();

  // (d) this block's slice of the outputs, two elements a thread: the NS
  // partials summed in chunk order, rounded to T
  const int pairs = GT * HD / 2, per = (pairs + NS - 1) / NS;
  for (int i = sp * per + tid; i < min(pairs, (sp + 1) * per); i += THREADS) {
    const int r = 2 * i / HD, d = 2 * i % HD;
    double2 x[NS_MAX];
#pragma unroll
    for (int j = 0; j < NS_MAX; ++j)
      if (j < NS)
        x[j] = *reinterpret_cast<const double2*>(cluster.map_shared_rank(part, j) +
                                                  r * L::PLD + d);
    double2 o = make_double2(0.0, 0.0);
#pragma unroll
    for (int j = 0; j < NS_MAX; ++j) {
      if (j < NS) {
        o.x += x[j].x;
        o.y += x[j].y;
      }
    }
    T* dst = out + (((size_t)b * Tq + r % Tq) * H + kvh * G + r / Tq) * HD + d;
    dst[0] = from_f<T>((float)o.x);
    dst[1] = from_f<T>((float)o.y);
  }
  cluster.sync();  // no block leaves while a peer reads its partial
}

// The kernel instance of (dtype, kv_fmt, HD) and its layout function, or
// null for one that is not built.
struct Instance {
  const void* fn;
  Layout (*lay)(int, int, int, int, bool);
};

Instance instance(int dtype, int kv_fmt, int HD) {
#define PA_I(T, H, F) \
  Instance { reinterpret_cast<const void*>(paged_attn_kernel<T, H, F>), layout<T, H, F> }
#define PA_FMTS(T, H) \
  {PA_I(T, H, KV_FP), PA_I(T, H, KV_I8), PA_I(T, H, KV_I4)}
  // the head widths a registered config serves (the LUT-serving model's 64,
  // qwen3-8b's 128); widen the set when a config needs another
  static const Instance table[2][2][3] = {
      {PA_FMTS(float, 64), PA_FMTS(float, 128)},
      {PA_FMTS(__nv_bfloat16, 64), PA_FMTS(__nv_bfloat16, 128)}};
#undef PA_FMTS
#undef PA_I
  if (dtype < 0 || dtype > 1 || kv_fmt < 0 || kv_fmt > 2 || (HD != 64 && HD != 128))
    return Instance{nullptr, nullptr};
  return table[dtype][HD == 128][kv_fmt];
}

// the kernel's dynamic shared-memory limit, raised to the most any plan
// takes once per (device, instance), not on every read
cudaError_t raise_smem_limit(int dtype, int kv_fmt, int HD, const void* fn) {
  static std::atomic<unsigned> raised[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << ((dtype * 2 + (HD == 128)) * 3 + kv_fmt);
  if (dev < 32 && (raised[dev].load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess && dev < 32) raised[dev].fetch_or(bit);
  return err;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int smem_bytes, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = grid.x;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Dynamic shared bytes of one block: Tq query rows of H over KV heads,
// chunks of CW pages of PS positions, the score buffer in shared memory
// (scores_here = 1) or in the scratch area.  -1 for an instance that is not
// built.
int paged_attention_smem(int dtype, int kv_fmt, int HD, int Tq, int H, int KV, int PS,
                         int CW, int scores_here) {
  const Instance in = instance(dtype, kv_fmt, HD);
  if (in.fn == nullptr || KV <= 0 || H % KV != 0) return -1;
  const int GTP = (H / KV * Tq + 15) & ~15;
  return in.lay(GTP, CW, Tq, ((CW * PS + 31) & ~31) + 4, scores_here != 0).total;
}

// Clusters of NS blocks of smem_bytes each that the device can hold at once
// (cudaOccupancyMaxActiveClusters) into *clusters; 0 means the plan cannot
// be scheduled.
int paged_attention_max_clusters(int dtype, int kv_fmt, int HD, int NS, int smem_bytes,
                                 int* clusters) {
  const Instance in = instance(dtype, kv_fmt, HD);
  if (in.fn == nullptr || NS <= 0 || NS > NS_MAX || smem_bytes > SMEM_MAX ||
      clusters == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit(dtype, kv_fmt, HD, in.fn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(NS), smem_bytes, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, in.fn, &cfg);
}

// dtype: 0 float32, 1 bfloat16 (of q and out).  HD: 64 or 128.  kv_fmt: 0
// fp pools [P,PS,KV,HD] of that dtype; 1 int8 codes [P,PS,KV,HD]; 2 int4 codes
// [P,PS,KV,HD/2] (HD % 64 == 0); quantized pools with float16 scales
// ks / vs [P,PS,KV,1], null for fp.  q [B,Tq,H,HD], table int32 [B,W], tpos
// int32 [B,Tq], out [B,Tq,H,HD], all contiguous and 16-byte aligned.  The
// positions of a row are split into NS chunks of CW pages (NS = ceil(W / CW)
// <= 8), one cluster of NS blocks per (KV head, row).  scratch: null, or
// float32 [B, KV, NS, ceil16(H/KV*Tq), ceil32(CW*PS) + 4] when the score
// buffer does not fit shared memory; smem_bytes: paged_attention_smem's for
// that choice (at most 227 KB).  bf16_softmax: 1 runs the bfloat16 score
// pipeline, 0 the float32 one.  Adds the CUDA launches it queued (1) to
// *launched.
int paged_attention_run(int dtype, int kv_fmt, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs, const void* table,
                        const void* tpos, void* out, void* scratch, int B, int Tq, int H,
                        int KV, int HD, int PS, int W, int CW, int NS, float div,
                        int additive, int bf16_softmax, int smem_bytes, void* stream,
                        int* launched) {
  const Instance in = instance(dtype, kv_fmt, HD);
  if (in.fn == nullptr || B <= 0 || Tq <= 0 || KV <= 0 || H % KV != 0 || PS <= 0 ||
      W <= 0 || CW <= 0 || NS != (W + CW - 1) / CW || NS > NS_MAX || launched == nullptr ||
      smem_bytes != paged_attention_smem(dtype, kv_fmt, HD, Tq, H, KV, PS, CW,
                                         scratch == nullptr) ||
      smem_bytes > SMEM_MAX || (kv_fmt != KV_FP && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit(dtype, kv_fmt, HD, in.fn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(NS, KV, B), smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  void* args[] = {&q, &k, &v, &ks, &vs, &table, &tpos, &out, &scratch, &Tq, &H,
                  &KV, &PS, &W, &CW, &div, &additive, &bf16_softmax};
  err = cudaLaunchKernelExC(&cfg, in.fn, args);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // extern "C"
