// Bit-plane (storage-free) DA VMM for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/bitplane_vmm.py:_bitplane_kernel
// (driven by bitplane_vmm_pallas -> _bitplane_vmm_call).
//
// Computes the exact int32 Y[M,N] = sum_b coef(b) * (xbit_b @ W), where
// xbit_b in {0,1} is bit b of the two's-complement pattern of the low
// x_bits bits of xq, coef(b) = 2^b and the sign plane of signed codes
// carries -2^(x_bits-1).  W holds int8 codes.
//
// Design.  A block owns BM=8 tokens x BN=64 output columns and walks a range
// of K in BK=128 steps.  Each step expands the [BM, BK] activation tile into
// its 8 bit-planes in shared memory, stacked on rows (row = plane*BM + m, 64
// rows of {0,1} int8), and stages the [BK, BN] weight tile transposed
// (column-major, k contiguous).  Four warps then run mma.sync
// m16n8k32 s8 x s8 -> s32 of the stacked planes against the weight codes:
// each plane row's product is that cycle's {0,1}-selected weight sum
// (the paper's per-cycle memory readout MR_b), exact in int32.  After the
// K range the per-plane sums go through shared memory and every output is
// formed by the paper's shift-and-add, MSB first: acc = 2*acc +/- MR_b, the
// sign plane subtracting.
//
// What bounds it on this card.  At decode (M <= 8) the work is
// 2*M*K*N*x_bits int8 operations against K*N bytes of codes: about 64
// operations per byte, far below the ~590 int8 operations per byte at which
// the H100 stops being limited by its 3.35 TB/s, so the weight stream is
// the bound.  The design keeps each weight byte read from device memory
// once per M tile (the 8 plane products reuse it from shared memory, like
// the TPU kernel's in-register plane decomposition), and splits K across
// blocks (split_k, exact integer atomicAdd into a zeroed output) when the
// N x M grid alone would leave SMs idle.  M tiles vary fastest in the grid
// so blocks sharing a weight tile run together and hit L2.
//
// The TPU kernel shrinks its K tile so each fp32 plane dot stays below 2^24
// (_fit_bk / _weight_code_bound).  With int32 accumulation that limit does
// not apply: the worst case 12288 * 127 * 255 is below 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;          // tokens per block
constexpr int PLANES = 8;      // plane rows per token (x_bits <= 8)
constexpr int ROWS = BM * PLANES;
constexpr int BN = 64;         // output columns per block
constexpr int BK = 128;        // K per shared-memory step
constexpr int PAD = 16;        // row padding (bytes) against bank conflicts
constexpr int LDS = BK + PAD;
constexpr int THREADS = 128;   // 4 warps, 16 columns each

__device__ __forceinline__ void mma_s8(int c[4], const int a[4], const int b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4x4 byte transpose: r[i] holds columns n..n+3 of row k+i; c[j] gets
// rows k..k+3 of column n+j (byte i = row k+i)
__device__ __forceinline__ void transpose4x4(const unsigned r[4], unsigned c[4]) {
  const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// per-thread share of one K step: X_ITEMS (token, 4 k) quads of the
// activation tile and W_ITEMS (4 k, 4 n) blocks of the weight tile
constexpr int X_ITEMS = BM * BK / 4 / THREADS;
constexpr int W_ITEMS = (BK / 4) * (BN / 4) / THREADS;
static_assert(X_ITEMS * THREADS * 4 == BM * BK, "x tile split");
static_assert(W_ITEMS * THREADS * 16 == BK * BN, "w tile split");

struct Staged {
  int x[X_ITEMS][4];
  unsigned w[W_ITEMS][4];
};

// global -> registers for the K step at k0 (zeros past the edges)
__device__ __forceinline__ void load_step(Staged& st, const int32_t* __restrict__ xq,
                                          const int8_t* __restrict__ w, int M, int K,
                                          int N, int ldw, int m0, int n0, int k0,
                                          int k_end, int mask, bool vec_x, bool vec_w,
                                          int tid) {
#pragma unroll
  for (int it = 0; it < X_ITEMS; ++it) {
    const int idx = tid + it * THREADS;
    const int m = idx / (BK / 4), kk = (idx % (BK / 4)) * 4;
    const int gm = m0 + m, gk = k0 + kk;
    if (gm < M && vec_x && gk + 3 < k_end) {
      const int4 v = *reinterpret_cast<const int4*>(xq + (size_t)gm * K + gk);
      st.x[it][0] = v.x & mask; st.x[it][1] = v.y & mask;
      st.x[it][2] = v.z & mask; st.x[it][3] = v.w & mask;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st.x[it][j] = (gm < M && gk + j < k_end) ? (xq[(size_t)gm * K + gk + j] & mask) : 0;
    }
  }
#pragma unroll
  for (int it = 0; it < W_ITEMS; ++it) {
    const int idx = tid + it * THREADS;
    const int kq = (idx / (BN / 4)) * 4, c4 = (idx % (BN / 4)) * 4;
    const int gn = n0 + c4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + kq + i;
      unsigned v = 0;
      if (gk < k_end) {
        const int8_t* src = w + (size_t)gk * ldw + gn;
        if (vec_w && gn + 3 < N) {
          v = *reinterpret_cast<const unsigned*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) v |= (unsigned)(uint8_t)src[j] << (8 * j);
        }
      }
      st.w[it][i] = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
bitplane_vmm_kernel(const int32_t* __restrict__ xq, const int8_t* __restrict__ w,
                    int32_t* __restrict__ y, int M, int K, int N, int ldw,
                    int x_bits, int x_signed, int k_per_split, int atomic) {
  __shared__ __align__(16) int8_t a_s[ROWS][LDS];   // stacked bit-planes
  __shared__ __align__(16) int8_t b_s[BN][LDS];     // W tile, k contiguous
  __shared__ int32_t d_s[ROWS][BN + 1];             // per-plane sums MR_b

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // groupID
  const int t = lane & 3;    // threadID_in_group
  const int mask = (1 << x_bits) - 1;
  const bool vec_x = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(xq) & 15) == 0);
  const bool vec_w = (ldw % 4 == 0) && ((reinterpret_cast<uintptr_t>(w) & 3) == 0);

  int acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Staged st;
  if (k_begin < k_end)
    load_step(st, xq, w, M, K, N, ldw, m0, n0, k_begin, k_end, mask, vec_x, vec_w, tid);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // registers -> shared: activations as {0,1} planes (row = plane*BM + m,
    // four k per 32-bit store), weights transposed to k-contiguous columns
#pragma unroll
    for (int it = 0; it < X_ITEMS; ++it) {
      const int idx = tid + it * THREADS;
      const int m = idx / (BK / 4), kk = (idx % (BK / 4)) * 4;
#pragma unroll
      for (int b = 0; b < PLANES; ++b) {
        const unsigned word = ((st.x[it][0] >> b) & 1) | (((st.x[it][1] >> b) & 1) << 8) |
                              (((st.x[it][2] >> b) & 1) << 16) |
                              (((unsigned)(st.x[it][3] >> b) & 1) << 24);
        *reinterpret_cast<unsigned*>(&a_s[b * BM + m][kk]) = word;
      }
    }
#pragma unroll
    for (int it = 0; it < W_ITEMS; ++it) {
      const int idx = tid + it * THREADS;
      const int kq = (idx / (BN / 4)) * 4, c4 = (idx % (BN / 4)) * 4;
      unsigned cols[4];
      transpose4x4(st.w[it], cols);
#pragma unroll
      for (int j = 0; j < 4; ++j) *reinterpret_cast<unsigned*>(&b_s[c4 + j][kq]) = cols[j];
    }
    __syncthreads();
    // the next step's loads fly while this step's products run
    if (k0 + BK < k_end)
      load_step(st, xq, w, M, K, N, ldw, m0, n0, k0 + BK, k_end, mask, vec_x, vec_w, tid);

#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      int bf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = warp * 16 + nt * 8 + g;
        bf[nt][0] = *reinterpret_cast<const int*>(&b_s[col][ks + t * 4]);
        bf[nt][1] = *reinterpret_cast<const int*>(&b_s[col][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        int af[4];
        af[0] = *reinterpret_cast<const int*>(&a_s[mt * 16 + g][ks + t * 4]);
        af[1] = *reinterpret_cast<const int*>(&a_s[mt * 16 + g + 8][ks + t * 4]);
        af[2] = *reinterpret_cast<const int*>(&a_s[mt * 16 + g][ks + 16 + t * 4]);
        af[3] = *reinterpret_cast<const int*>(&a_s[mt * 16 + g + 8][ks + 16 + t * 4]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_s8(acc[mt][nt], af, bf[nt]);
      }
    }
    __syncthreads();
  }

  // per-plane sums to shared memory (C fragment: rows g / g+8, cols 2t, 2t+1)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = warp * 16 + nt * 8 + t * 2;
      d_s[mt * 16 + g][col] = acc[mt][nt][0];
      d_s[mt * 16 + g][col + 1] = acc[mt][nt][1];
      d_s[mt * 16 + g + 8][col] = acc[mt][nt][2];
      d_s[mt * 16 + g + 8][col + 1] = acc[mt][nt][3];
    }
  __syncthreads();

  // shift-and-add over the planes, MSB first; the sign plane subtracts
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int m = idx / BN, n = idx % BN;
    const int gm = m0 + m, gn = n0 + n;
    if (gm >= M || gn >= N) continue;
    int out = 0;
    for (int b = x_bits - 1; b >= 0; --b) {
      const int mr = d_s[b * BM + m][n];
      out = 2 * out + ((x_signed && b == x_bits - 1) ? -mr : mr);
    }
    if (atomic)
      atomicAdd(&y[(size_t)gm * N + gn], out);
    else
      y[(size_t)gm * N + gn] = out;
  }
}

}  // namespace

extern "C" {

// xq int32 [M, K] contiguous; w int8 [K, N] with row stride ldw >= N;
// y int32 [M, N] contiguous (zeroed by the caller when split_k > 1).
int bitplane_vmm_s8(const void* xq, const void* w, void* y, int M, int K,
                    int N, int ldw, int x_bits, int x_signed, int split_k,
                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || x_bits < 1 || x_bits > PLANES ||
      split_k < 1 || ldw < N)
    return (int)cudaErrorInvalidValue;
  int k_per_split = (K + split_k - 1) / split_k;
  k_per_split = ((k_per_split + BK - 1) / BK) * BK;
  const int splits = (K + k_per_split - 1) / k_per_split;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  bitplane_vmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xq, (const int8_t*)w, (int32_t*)y, M, K, N, ldw, x_bits,
      x_signed, k_per_split, splits > 1 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
