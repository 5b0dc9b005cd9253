// Bit-plane (storage-free) DA VMM for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/bitplane_vmm.py:_bitplane_kernel
// (driven by bitplane_vmm_pallas -> _bitplane_vmm_call), and that kernel
// batched over stacked experts: jax.vmap of it in src/repro/core/engine.py:
// dense lowers to one pallas_call whose grid leads with the expert.
//
// Computes the exact int32 Y[M,N] = sum_b coef(b) * (xbit_b @ W), where
// xbit_b in {0,1} is bit b of the two's-complement pattern of the low
// x_bits bits of xq, coef(b) = 2^b and the sign plane of signed codes
// carries -2^(x_bits-1).  W holds int8 codes.  With E experts the same holds
// for each: Y[e] from xq[e] and W[e], all in one launch.
//
// What bounds it on this card.  At decode (M <= 8) the work is
// 2*M*K*N*x_bits int8 operations against K*N bytes of codes: about 64
// operations per byte, far below the ~590 int8 operations per byte at which
// the H100 stops being limited by its 3.35 TB/s, so the weight stream is
// the bound, and the kernel has to keep enough weight bytes in flight.  At
// prefill (M = 64) the 8 plane products make it 512 operations per byte:
// near the ridge, so the tensor pipe and the instructions that feed it
// count as much as the bytes.
//
// Design.  A block owns TB tokens x BN = 128 output columns and a range of
// K, walked in BK = 128 steps.  The plane rows are (token, plane): a 16-row
// mma.sync m16n8k32 s8 tile holds two tokens' 8 planes, and each row's
// product with the weight codes is that cycle's {0,1}-selected weight sum
// (the paper's per-cycle memory readout MR_b), exact in int32.
//  - Weights: a ring of STAGES [BK, BN] int8 tiles in shared memory, filled
//    by 16-byte cp.async (zero-filled past K and N) STAGES - 1 steps ahead:
//    each block keeps 48 KB of weight bytes in flight.  The tile stays
//    row-major (n contiguous); chunk c of row r sits at chunk c ^ 2*(r/4 % 4)
//    so the fragment loads below are free of bank conflicts.  A B fragment
//    needs 4 consecutive k of one column; a thread reads 4 rows x 4 columns
//    (one 32-bit word per row) and byte-permutes them into the 4 columns'
//    fragments, so its logical column g of n-tile j is the physical column
//    4g + j of its warp's 32.  No transpose pass, one barrier per step.
//  - Activations: loaded to registers one step ahead, their low bytes packed
//    four to a word into a double-buffered shared tile; the A fragment of
//    plane g is (word >> g) & 0x01010101, formed by the thread that owns
//    plane-g rows.
//  - Epilogue: each thread scales its plane's sums by coef(g) (a shift; the
//    sign plane negates) and a reduce-scatter over the 8 lanes that hold a
//    column's planes forms sum_b coef(b) * MR_b; wrapping int32 addition is
//    order-free, so this is the paper's shift-and-add exactly.
//  - Tiles by M (kernels/bitplane_vmm.py: bitplane_plan): TB = 2, 4 or 8
//    tokens (4 warps, one column quarter each) at decode; above that 16 or
//    32 tokens (8 or 16 warps: 2 or 4 token slices of 8 tokens = 64 plane
//    rows each), so each weight tile serves up to 256 plane rows.  K splits across blocks (exact int32
//    atomicAdd into an output the entry point zeroes) when the tiles alone
//    would leave SMs idle.  Token tiles vary fastest in the grid, so blocks
//    sharing a weight tile run together and hit L2.
//  - Experts: the grid's z is expert x K range (z = e * splits + s), and a
//    block offsets its codes, weights and output by its expert's strides,
//    taken in 64 bits (one expert of a [16, 8192, 24576] stack starts past
//    2^31 bytes).  The tiles of all experts fill the card together, so a
//    decode-sized stack needs no K split; a single matrix is E = 1.
//  - Ragged and misaligned operands: K and N edges are zero-filled by the
//    copies; a weight matrix whose rows are not 16-byte aligned (ldw % 16 or
//    the base) is staged by plain byte loads into the same ring.
//
// The TPU kernel shrinks its K tile so each fp32 plane dot stays below 2^24
// (_fit_bk / _weight_code_bound).  With int32 accumulation that limit does
// not apply: the worst case 12288 * 128 * 255 is below 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BN = 128;        // output columns per block: 32 per warp
constexpr int BK = 128;        // K per pipeline step
constexpr int STAGES = 4;      // weight tiles in the ring
constexpr int W_TILE = BK * BN;
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory of the largest tile (TB = 32)
constexpr int SMEM_MAX = STAGES * W_TILE + 2 * 32 * BK;

__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4], const unsigned b[2]) {
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one step of a reduce-scatter over lanes lane ^ mask: the lane whose mask
// bit is set keeps v[H .. 2H) (moved to v[0 .. H)), the other v[0 .. H),
// each summed with its partner's copy
template <int H>
__device__ __forceinline__ void reduce_half(unsigned v[], int lane, int mask) {
  const bool up = lane & mask;
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const unsigned send = up ? v[e] : v[e + H];
    const unsigned keep = up ? v[e + H] : v[e];
    v[e] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

// byte offset of chunk ch (16 bytes) of row r in a weight tile
__device__ __forceinline__ int w_off(int r, int ch) {
  return r * BN + ((ch ^ (2 * ((r >> 2) & 3))) << 4);
}

// MT m16 tiles (2 tokens each) per warp, WM warps along M (4 along N each):
// TB = 2 * MT * WM tokens per block.  ALIGNED: w and ldw 16-byte aligned.
template <int MT, int WM, bool ALIGNED>
__global__ void __launch_bounds__(128 * WM)
bitplane_vmm_kernel(const int32_t* __restrict__ xq, const int8_t* __restrict__ w,
                    int32_t* __restrict__ y, int M, int K, int N, int ldw,
                    long long sxe, long long swe, long long sye, int x_bits,
                    int x_signed, int k_per_split, int atomic) {
  constexpr int THREADS = 128 * WM;
  constexpr int TB = 2 * MT * WM;
  constexpr int XQ = TB * BK / 4;                      // code quads per step
  constexpr int XI = (XQ + THREADS - 1) / THREADS;     // quads per thread
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* w_s = smem;                                         // ring
  unsigned* x_s = reinterpret_cast<unsigned*>(smem + STAGES * W_TILE);  // [2][TB][BK/4]

  const int splits = (K + k_per_split - 1) / k_per_split;
  const int e = blockIdx.z / splits;
  xq += e * sxe;
  w += e * swe;
  y += e * sye;
  const int m0 = blockIdx.x * TB;
  const int n0 = blockIdx.y * BN;
  const int k_begin = (blockIdx.z - e * splits) * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nsteps = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2;   // groupID: this thread's plane
  const int t = lane & 3;    // threadID_in_group
  const bool vec_x = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(xq) & 15) == 0);

  // weight tile of step s into its ring slot (zeros past K and N)
  auto issue_w = [&](int s) {
    const int kb = k_begin + s * BK;
    unsigned char* dst = w_s + (s % STAGES) * W_TILE;
    for (int c = tid; c < BK * (BN / 16); c += THREADS) {
      const int r = c >> 3, ch = c & 7;
      const int gk = kb + r, gn = n0 + ch * 16;
      const bool row = gk < k_end;
      if constexpr (ALIGNED) {
        const int bytes = row ? max(0, min(16, N - gn)) : 0;
        cp_async16(dst + w_off(r, ch), bytes ? w + (size_t)gk * ldw + gn : w, bytes);
      } else {
        unsigned v[4] = {0u, 0u, 0u, 0u};
        if (row) {
          const int8_t* src = w + (size_t)gk * ldw + gn;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (gn + j < N) v[j >> 2] |= (unsigned)(uint8_t)src[j] << (8 * (j & 3));
        }
        *reinterpret_cast<uint4*>(dst + w_off(r, ch)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    cp_async_commit();
  };

  // the codes of step s into registers (zeros past M and K)
  int4 xr[XI];
  auto load_x = [&](int s) {
    const int kb = k_begin + s * BK;
#pragma unroll
    for (int it = 0; it < XI; ++it) {
      const int q = tid + it * THREADS;
      const int m = q / (BK / 4), gk = kb + (q % (BK / 4)) * 4;
      const int gm = m0 + m;
      int4 v = make_int4(0, 0, 0, 0);
      if (q < XQ && gm < M) {
        const int32_t* src = xq + (size_t)gm * K + gk;
        if (vec_x && gk + 3 < k_end) {
          v = __ldg(reinterpret_cast<const int4*>(src));
        } else {
          v.x = gk < k_end ? __ldg(src) : 0;
          v.y = gk + 1 < k_end ? __ldg(src + 1) : 0;
          v.z = gk + 2 < k_end ? __ldg(src + 2) : 0;
          v.w = gk + 3 < k_end ? __ldg(src + 3) : 0;
        }
      }
      xr[it] = v;
    }
  };
  // their low bytes, four codes to a word, into x_s[s & 1]
  auto store_x = [&](int s) {
    unsigned* dst = x_s + (s & 1) * (TB * BK / 4);
#pragma unroll
    for (int it = 0; it < XI; ++it) {
      const int q = tid + it * THREADS;
      if (q < XQ)
        dst[q] = __byte_perm(__byte_perm((unsigned)xr[it].x, (unsigned)xr[it].y, 0x0040),
                             __byte_perm((unsigned)xr[it].z, (unsigned)xr[it].w, 0x0040),
                             0x5410);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const bool plane_live = g < x_bits;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps)
      issue_w(s);
    else
      cp_async_commit();  // keep one group per step
  }
  if (nsteps > 0) load_x(0);

  for (int i = 0; i < nsteps; ++i) {
    store_x(i);
    if (i + 1 < nsteps) load_x(i + 1);  // in flight during this step's products
    cp_async_wait<STAGES - 2>();        // this thread's copies of step i landed
    __syncthreads();                    // everyone's landed; step i - 1 is read
    if (i + STAGES - 1 < nsteps)
      issue_w(i + STAGES - 1);  // into the slot step i - 1 used
    else
      cp_async_commit();

    const unsigned char* ws = w_s + (i % STAGES) * W_TILE;
    const unsigned* xs = x_s + (i & 1) * (TB * BK / 4) + (wm * 2 * MT) * (BK / 4);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      // B fragments of the warp's 32 columns: n-tile j, logical column g is
      // physical column 32 * wn + 4 * g + j
      unsigned bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4], c[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int row = ks + 16 * h + 4 * t + ii;
          r[ii] = *reinterpret_cast<const unsigned*>(ws + w_off(row, 2 * wn + (g >> 2)) +
                                                     4 * (g & 3));
        }
        transpose4x4(r, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j][h] = c[j];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // rows g / g + 8: plane g of tokens 2 mt / 2 mt + 1
        const unsigned* x0 = xs + (2 * mt) * (BK / 4) + ks / 4 + t;
        const unsigned* x1 = x0 + BK / 4;
        unsigned a[4];
        a[0] = plane_live ? (x0[0] >> g) & 0x01010101u : 0u;
        a[1] = plane_live ? (x1[0] >> g) & 0x01010101u : 0u;
        a[2] = plane_live ? (x0[4] >> g) & 0x01010101u : 0u;
        a[3] = plane_live ? (x1[4] >> g) & 0x01010101u : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, bf[j]);
      }
    }
  }
  cp_async_wait<0>();

  // shift-and-add: coef(g) * MR_g (the sign plane negates), then a
  // reduce-scatter over the 8 lanes of one t (lane bits 2-4 = g) sums the
  // planes; lane g keeps n-tile j = g >> 1, token 2 mt + (g & 1)
  const bool neg = x_signed && g == x_bits - 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    unsigned v[16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned s = (unsigned)acc[mt][j][q] << g;
        v[j * 4 + q] = neg ? 0u - s : s;
      }
    reduce_half<8>(v, lane, 16);  // keep n-tiles 2 (g >> 2) .. + 1
    reduce_half<4>(v, lane, 8);   // keep n-tile g >> 1
    reduce_half<2>(v, lane, 4);   // keep token 2 mt + (g & 1)
    const int gm = m0 + wm * 2 * MT + 2 * mt + (g & 1);
    const int gn = n0 + 32 * wn + 8 * t + (g >> 1);
    if (gm < M) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = gn + 4 * e;
        if (n < N) {
          int32_t* o = y + (size_t)gm * N + n;
          if (atomic)
            atomicAdd(o, (int32_t)v[e]);
          else
            *o = (int32_t)v[e];
        }
      }
    }
  }
}

template <int MT, int WM, bool ALIGNED>
int launch(dim3 grid, cudaStream_t st, const int32_t* xq, const int8_t* w, int32_t* y,
           int M, int K, int N, int ldw, long long sxe, long long swe, long long sye,
           int x_bits, int x_signed, int k_per_split, int atomic) {
  // the dynamic shared-memory limit, raised once per device
  static std::atomic<unsigned> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !((raised.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(bitplane_vmm_kernel<MT, WM, ALIGNED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised.fetch_or(1u << dev);
  }
  const int smem = STAGES * W_TILE + 2 * (2 * MT * WM) * BK;
  bitplane_vmm_kernel<MT, WM, ALIGNED><<<grid, 128 * WM, smem, st>>>(
      xq, w, y, M, K, N, ldw, sxe, swe, sye, x_bits, x_signed, k_per_split, atomic);
  return 0;
}

template <bool ALIGNED>
int dispatch(int mt, int wm, dim3 grid, cudaStream_t st, const int32_t* xq,
             const int8_t* w, int32_t* y, int M, int K, int N, int ldw, long long sxe,
             long long swe, long long sye, int x_bits, int x_signed, int k_per_split,
             int atomic) {
  if (wm == 1 && mt == 1)
    return launch<1, 1, ALIGNED>(grid, st, xq, w, y, M, K, N, ldw, sxe, swe, sye, x_bits, x_signed,
                                       k_per_split, atomic);
  if (wm == 1 && mt == 2)
    return launch<2, 1, ALIGNED>(grid, st, xq, w, y, M, K, N, ldw, sxe, swe, sye, x_bits, x_signed,
                                       k_per_split, atomic);
  if (wm == 1 && mt == 4)
    return launch<4, 1, ALIGNED>(grid, st, xq, w, y, M, K, N, ldw, sxe, swe, sye, x_bits, x_signed,
                                       k_per_split, atomic);
  if (wm == 2 && mt == 4)
    return launch<4, 2, ALIGNED>(grid, st, xq, w, y, M, K, N, ldw, sxe, swe, sye, x_bits, x_signed,
                                       k_per_split, atomic);
  if (wm == 4 && mt == 4)
    return launch<4, 4, ALIGNED>(grid, st, xq, w, y, M, K, N, ldw, sxe, swe, sye, x_bits, x_signed,
                                       k_per_split, atomic);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// E experts, each xq int32 [M, K] contiguous, w int8 [K, N] with row stride
// ldw >= N and y int32 [M, N] contiguous; expert e's start at element
// e * sxe, e * swe and e * sye of xq, w and y (64-bit: a stack may pass 2^31
// elements; the experts' outputs must not overlap).  E = 1 is one matrix.
// The tile (kernels/bitplane_vmm.py: bitplane_plan): mt m16 tiles per warp
// and wm warps along M (mt, wm) in (1,1) (2,1) (4,1) (4,2) (4,4); K in
// ranges of k_per_split, a multiple of 128.  With more than one range every
// expert's output is zeroed first (one more launch).  Adds the CUDA
// launches it queued to *launched.
int bitplane_vmm_s8(const void* xq, const void* w, void* y, int E, int M, int K, int N,
                    int ldw, long long sxe, long long swe, long long sye, int x_bits,
                    int x_signed, int mt, int wm, int k_per_split, void* stream,
                    int* launched) {
  const bool tile = wm == 1 ? (mt == 1 || mt == 2 || mt == 4) : mt == 4 && (wm == 2 || wm == 4);
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || x_bits < 1 || x_bits > 8 || ldw < N ||
      k_per_split < BK || k_per_split % BK || !tile ||
      (E > 1 && (sxe < 0 || swe < 0 || sye < (long long)M * N)))
    return (int)cudaErrorInvalidValue;
  const int tb = 2 * mt * wm;
  const int splits = (K + k_per_split - 1) / k_per_split;
  if ((N + BN - 1) / BN > 65535 || (long long)E * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + tb - 1) / tb, (N + BN - 1) / BN, E * splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int atomic = splits > 1;
  cudaError_t err;
  if (atomic) {  // the span from expert 0's output to the end of expert E - 1's
    err = cudaMemsetAsync(y, 0, ((size_t)(E - 1) * sye + (size_t)M * N) * sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  const bool aligned = ldw % 16 == 0 && (E == 1 || swe % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int32_t* x = static_cast<const int32_t*>(xq);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* yp = static_cast<int32_t*>(y);
  const int e = aligned ? dispatch<true>(mt, wm, grid, st, x, wp, yp, M, K, N, ldw, sxe, swe,
                                         sye, x_bits, x_signed, k_per_split, atomic)
                        : dispatch<false>(mt, wm, grid, st, x, wp, yp, M, K, N, ldw, sxe,
                                          swe, sye, x_bits, x_signed, k_per_split, atomic);
  if (e) return e;
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // extern "C"
