// Native-wire DBB matmuls for Hopper (sm_90a): the W-DBB kernel (#1) and
// the joint A/W-DBB kernel (#4), one templated body each way.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/dbb_matmul.py::dbb_matmul_pallas     (_dbb_matmul_kernel)
//   repro/kernels/dbb_matmul.py::dbb_matmul_aw_pallas  (_dbb_matmul_aw_kernel)
// and computes their oracles in kernels/ref.py (dbb_matmul_ref,
// dbb_matmul_aw_ref):
//   out[m, n] = act(acc[m, n] + bias[n])   then the cast to the output dtype
//   acc       = sum_k decode_a(x)[m, k] * decode_w(w)[k, n]   (f32 accumulator)
// with the wire values in the model dtype (bf16 or f32) and the epilogue
// (epilogue.apply_epilogue) on the f32 accumulator.
//
// What bounds it on the H100.  At the serving shapes (M = max_batch = 4 on
// decode, M = 64 on a mixed prefill step, K up to 6400, N up to 73472) the
// work is the packed weight stream: 1.125 bytes per weight element at 4/8
// in bf16 (NNZ bf16 values + one mask byte per 8-block) against 2*M
// operations per weight element, at M <= 64 at most 2 * 64 / 1.125 = 114
// operations per byte, below the card's ~295 bf16 operations per byte.
// So the bound is bytes (3.35 TB/s), not operations, and mma.sync keeps
// up: wgmma's higher rate would buy nothing until M passes ~150 rows.
//
// Two bodies.  Every bf16 call whose shape it takes runs the tc body
// (dbb_tc_kernel, counted in NATIVE_TC / AW_NATIVE_TC by the wrapper):
// N % 8 == 0, K % 64 == 0, NNZ <= 4, aligned operands, a plan of at most 8
// K splits.  Other shapes and every f32 call run the generic body
// (dbb_bf16_kernel, dbb_f32_kernel), which keeps a workspace and a second
// launch for split-K.  Both sum a row's k in the same order: k-steps of 16
// in ascending order within a split, then the splits' partials in split
// order, then bias and activation.  The split plan is the caller's, from
// (K, N) only, never from M: a row's output is bitwise the same whatever
// M or the other rows are, so batch invariance holds on the card.  No
// float atomics, no order that depends on arrival.
//
// The tc body.  A block owns a BM x BN output tile (BM 16 or 64 rows, BN
// 64 or 128 columns) and one K split, in k-steps of 8 8-blocks:
// - A ring of TC_STAGES k-steps in shared memory, filled by cp.async with
//   the operands as they lie in device memory (w_vals [8][NNZ][BN],
//   w_mask [8][BN], x_vals/x_mask or dense x), 16 bytes a thread (8 for the
//   masks), each thread's chunks worked out once: the next step is in
//   flight while one is decoded and multiplied.  Rows and columns past the
//   tile's edge are zero-filled by the copy itself.  Two stages (not three
//   or four: no faster) keep a block at 63 KB and 80 registers, so three
//   blocks share an SM and hide each other's decode latency.
// - Each step decodes the raw stage into dense tiles, once for the
//   block: the weights into a B tile [BN][k] (a thread one 8-block of two
//   adjacent columns), #4's activations into an A tile [BM][k] (a thread
//   one (row, 8-block)); #1's dense x lands in the ring as its A tile.
//   An 8-block decodes by a table indexed by its mask byte, built per
//   launch for the operand's NNZ (at most 4): for each pair of positions
//   a byte_perm selector that picks each position's value by its rank
//   popcount(mask & (2^p - 1)) from the block's four values in two
//   registers, and one that zeroes the positions whose bit is clear.
//   Eight byte permutes an 8-block: no branch, no popcount, no indexed
//   register.  Every warp then takes its A and B fragments by ldmatrix
//   (rows padded by 16 bytes) into mma.sync.m16n8k16.  Decoding straight
//   into B fragments (a lane's k pair at its rank) was the first design:
//   each lane's chain of dependent loads left the SMs idle (PERF.md).
// - Split-K in a thread-block cluster: the n_split blocks of one output
//   tile are one cluster (at most 8).  Each writes its f32 partial to its
//   own shared memory; after the cluster's barrier each sums a share of
//   the tile over the partials through distributed shared memory, in
//   split order, and runs the epilogue.  Partials never leave the chip and
//   there is no second launch.
// Every bf16 product is exact in f32, so only the order of the sums
// differs from the oracle's (float64, rounded once).
//
// The generic body (the port's first): one thread decodes an 8-block of four
// adjacent columns into shared rows of k-consecutive values, bf16 on the
// tensor cores (mma.sync), f32 with scalar FFMA (never TF32: the oracle is
// full f32), synchronous loads; a second kernel adds the splits' f32
// partials from a workspace in split order before the epilogue.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64;         // output columns per block
constexpr int THREADS = 256;   // 8 warps

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

// Per element type: reduction depth per shared-memory step and the padded
// shared row (bf16 rows of 136 values = 68 words: conflict-free fragment
// reads; both rows are a multiple of 16 bytes for vector stores).
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BK = 128;
  static constexpr int ROW = BK + 8;
};
template <> struct Tile<float> {
  static constexpr int BK = 64;
  static constexpr int ROW = BK + 4;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// Rank-decode one 8-block: v holds the value slots; slots past nnz-1
// clamp like the oracle's gather.
template <typename T>
__device__ __forceinline__ void decode8(unsigned mask, int nnz, const T (&v)[8], T (&d)[8]) {
  int r = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if ((mask >> b) & 1u) {
      d[b] = v[r < nnz - 1 ? r : nnz - 1];
      ++r;
    } else {
      d[b] = zero<T>();
    }
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const __nv_bfloat16 (&d)[8]) {
  uint4 u;
  memcpy(&u, d, sizeof(u));
  *(uint4*)dst = u;
}
__device__ __forceinline__ void store8(float* dst, const float (&d)[8]) {
  *(float4*)dst = make_float4(d[0], d[1], d[2], d[3]);
  *(float4*)(dst + 4) = make_float4(d[4], d[5], d[6], d[7]);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, __nv_bfloat16 (&d)[8]) {
  const uint4 u = *(const uint4*)src;
  memcpy(d, &u, sizeof(u));
}
__device__ __forceinline__ void load8(const float* src, float (&d)[8]) {
  const float4 a = *(const float4*)src, b = *(const float4*)(src + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* src, __nv_bfloat16 (&d)[4]) {
  const uint2 u = *(const uint2*)src;
  memcpy(d, &u, sizeof(u));
}
__device__ __forceinline__ void load4(const float* src, float (&d)[4]) {
  const float4 u = *(const float4*)src;
  d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.0f);
  if (ACT == ACT_SILU) {
    float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
    return __fmul_rn(y, sig);
  }
  if (ACT == ACT_GELU) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    float inner = __fmul_rn(c, __fadd_rn(y, __fmul_rn(0.044715f, __fmul_rn(y, __fmul_rn(y, y)))));
    return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, tanhf(inner)));
  }
  return y;
}

__device__ __forceinline__ void store(float* p, float y) { *p = y; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float y) { *p = __float2bfloat16_rn(y); }

// out[m, n] from the f32 accumulator: the oracle's epilogue order
template <typename OutT, int ACT>
__device__ __forceinline__ void finish(float acc, int m, int n, int N, const float* bias,
                                       OutT* out) {
  float y = acc;
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  store(out + (size_t)m * N + n, activate<ACT>(y));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Decode one BK-deep step of both operands into shared memory.
// xs [BM][ROW]: row mm holds x[m0 + mm, k0 .. k0 + BK); ws [BN][ROW]: row
// nn holds w[k0 .. k0 + BK, n0 + nn].  Out-of-range rows, columns and
// 8-blocks (kb >= kb_end) are zero, which adds nothing to any sum.
template <typename T, int BM, bool PACKED_A>
__device__ __forceinline__ void load_step(T* xs, T* ws, const T* __restrict__ x,
                                          const uint8_t* __restrict__ x_mask,
                                          const T* __restrict__ w_vals,
                                          const uint8_t* __restrict__ w_mask, int M, int N,
                                          int KB, int nnz_a, int nnz_w, int m0, int n0, int kb0,
                                          int kb_end) {
  constexpr int ROW = Tile<T>::ROW, KBT = Tile<T>::BK / 8;
  const int tid = threadIdx.x;
  const bool vec = (N & 3) == 0;
  // weights: one thread per (8-block, 4 adjacent columns)
  for (int p = tid; p < (BN / 4) * KBT; p += THREADS) {
    const int n4 = (p % (BN / 4)) * 4, bb = p / (BN / 4);
    const int n = n0 + n4, kb = kb0 + bb;
    T d[4][8];
    if (kb < kb_end && n < N) {
      unsigned masks[4];
      T v[4][8];
      if (vec) {
        const uint32_t mw = *(const uint32_t*)(w_mask + (size_t)kb * N + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) masks[c] = (mw >> (8 * c)) & 0xFFu;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) masks[c] = n + c < N ? w_mask[(size_t)kb * N + n + c] : 0u;
      }
      const T* base = w_vals + (size_t)kb * nnz_w * N + n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c][j] = zero<T>();
        if (j < nnz_w) {
          const T* row = base + (size_t)j * N;
          if (vec) {
            T q[4];
            load4(row, q);
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c][j] = q[c];
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (n + c < N) v[c][j] = row[c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) decode8(masks[c], nnz_w, v[c], d[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int b = 0; b < 8; ++b) d[c][b] = zero<T>();
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) store8(ws + (n4 + c) * ROW + 8 * bb, d[c]);
  }
  // activations: one thread per (row, 8-block)
  for (int p = tid; p < BM * KBT; p += THREADS) {
    const int mm = p / KBT, bb = p % KBT;
    const int m = m0 + mm, kb = kb0 + bb;
    T d[8];
    if (m < M && kb < kb_end) {
      if (PACKED_A) {
        const T* src = x + ((size_t)m * KB + kb) * nnz_a;
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = j < nnz_a ? src[j] : zero<T>();
        decode8(x_mask[(size_t)m * KB + kb], nnz_a, v, d);
      } else {
        load8(x + (size_t)m * KB * 8 + (size_t)kb * 8, d);
      }
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) d[b] = zero<T>();
    }
    store8(xs + mm * ROW + 8 * bb, d);
  }
}

// bf16 operands on the tensor cores.  TM: 16-row tiles per block (BM =
// 16 * TM).  8 warps split the block's TM x 8 grid of 16x8 tiles: warp w
// takes row tile w % TM and the NT = TM column tiles starting at
// (w / TM) * NT.  SPLIT: write this block's partial sums (its K range)
// to part[blockIdx.z] instead of finishing.
template <int TM, bool PACKED_A, bool SPLIT, typename OutT, int ACT>
__global__ void __launch_bounds__(THREADS)
dbb_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ x_mask,
                const __nv_bfloat16* __restrict__ w_vals, const uint8_t* __restrict__ w_mask,
                const float* __restrict__ bias, OutT* __restrict__ out,
                float* __restrict__ part, int M, int N, int KB, int nnz_a, int nnz_w,
                int kb_per_split) {
  using T = __nv_bfloat16;
  constexpr int BM = 16 * TM, NT = TM;
  constexpr int ROW = Tile<T>::ROW, BK = Tile<T>::BK, KBT = BK / 8, RW = ROW / 2;
  __shared__ __align__(16) T xs[BM * ROW];
  __shared__ __align__(16) T ws[BN * ROW];
  const uint32_t* xw = (const uint32_t*)xs;
  const uint32_t* ww = (const uint32_t*)ws;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp % TM) * 16, wn = (warp / TM) * NT * 8;
  const int kb_begin = blockIdx.z * kb_per_split;
  const int kb_end = min(KB, kb_begin + kb_per_split);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kb0 = kb_begin; kb0 < kb_end; kb0 += KBT) {
    load_step<T, BM, PACKED_A>(xs, ws, x, x_mask, w_vals, w_mask, M, N, KB, nnz_a, nnz_w, m0,
                               n0, kb0, kb_end);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK / 2; kw += 8) {  // 16-deep k slices, 8 words each
      const uint32_t a0 = xw[(wm + g) * RW + kw + t], a1 = xw[(wm + g + 8) * RW + kw + t];
      const uint32_t a2 = xw[(wm + g) * RW + kw + t + 4];
      const uint32_t a3 = xw[(wm + g + 8) * RW + kw + t + 4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nc = wn + j * 8 + g;
        mma_bf16(acc[j], a0, a1, a2, a3, ww[nc * RW + kw + t], ww[nc * RW + kw + t + 4]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + wm + g + (i >= 2 ? 8 : 0);
      const int n = n0 + wn + j * 8 + 2 * t + (i & 1);
      if (m >= M || n >= N) continue;
      if (SPLIT) part[((size_t)blockIdx.z * M + m) * N + n] = acc[j][i];
      else finish<OutT, ACT>(acc[j][i], m, n, N, bias, out);
    }
  }
}

// f32 operands with scalar FFMA: a 64 x 64 tile, 4 x 4 outputs a thread
// (rows tr + 16 i, columns tc + 16 j), each summing its k in order.
template <bool PACKED_A, bool SPLIT, typename OutT, int ACT>
__global__ void __launch_bounds__(THREADS)
dbb_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ x_mask,
               const float* __restrict__ w_vals, const uint8_t* __restrict__ w_mask,
               const float* __restrict__ bias, OutT* __restrict__ out, float* __restrict__ part,
               int M, int N, int KB, int nnz_a, int nnz_w, int kb_per_split) {
  using T = float;
  constexpr int BM = 64;
  constexpr int ROW = Tile<T>::ROW, BK = Tile<T>::BK, KBT = BK / 8;
  __shared__ __align__(16) T xs[BM * ROW];
  __shared__ __align__(16) T ws[BN * ROW];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb_begin = blockIdx.z * kb_per_split;
  const int kb_end = min(KB, kb_begin + kb_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kb0 = kb_begin; kb0 < kb_end; kb0 += KBT) {
    load_step<T, BM, PACKED_A>(xs, ws, x, x_mask, w_vals, w_mask, M, N, KB, nnz_a, nnz_w, m0,
                               n0, kb0, kb_end);
    __syncthreads();
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(tr + 16 * i) * ROW + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[(tc + 16 * j) * ROW + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tr + 16 * i, n = n0 + tc + 16 * j;
      if (m >= M || n >= N) continue;
      if (SPLIT) part[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
      else finish<OutT, ACT>(acc[i][j], m, n, N, bias, out);
    }
  }
}

// Adds the splits' partials in split order, then the epilogue; one thread
// per output.
template <typename OutT, int ACT>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, int n_split, const float* __restrict__ bias,
              OutT* __restrict__ out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = part[i];
  for (int j = 1; j < n_split; ++j) s = __fadd_rn(s, part[(size_t)j * total + i]);
  finish<OutT, ACT>(s, (int)(i / N), (int)(i % N), N, bias, out);
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16, "tc"): a cp.async ring of raw packed tiles,
// rank-decode from shared memory, split-K summed in a thread-block cluster.

constexpr int TC_THREADS = 256;  // 8 warps
constexpr int TC_STAGES = 2;     // k-steps of the ring: one in use, one in flight
constexpr int TC_KBT = 8;        // 8-blocks per k-step (64 k, four m16n8k16 k-steps)
constexpr int TC_AROW = 8 * TC_KBT + 8;  // bf16 per row of an A tile: 64 k + 16 bytes of pad
constexpr int TC_MAX_SPLIT = 8;  // blocks of a cluster (the portable size)

__host__ __device__ inline int align16i(int x) { return (x + 15) & ~15; }

// Byte offsets of the tc body's dynamic shared memory.  A stage of the
// ring holds one k-step as it lies in device memory: w_vals [KBT][NNZw][BN],
// w_mask [KBT][BN], and x_vals [BM][KBT * NNZa] with x_mask [BM][KBT] (#4)
// or x [BM][64] (#1, rows padded to 72 values: the A tile itself).  Each
// step decodes the weights into one dense B tile [BN][72] and, for #4, the
// activations into one A tile [BM][72] (k consecutive, 16 bytes of pad a
// row: conflict-free ldmatrix).  The
// decode tables of the two operands come last.  After the loop the same
// memory holds the block's f32 partial [BM][BN + 4] for the cluster's sum.
struct TcSmem {
  int wv, wm, xa, xm, stage, btile, atile, lut_w, lut_a, part_row, total;
};

__host__ __device__ inline TcSmem tc_smem(int BM, int BN, int nnz_w, int nnz_a, bool packed) {
  TcSmem L;
  L.wv = 0;
  L.wm = align16i(L.wv + TC_KBT * nnz_w * BN * 2);
  L.xa = align16i(L.wm + TC_KBT * BN);
  L.xm = align16i(L.xa + (packed ? BM * TC_KBT * nnz_a * 2 : BM * TC_AROW * 2));
  L.stage = align16i(L.xm + (packed ? BM * TC_KBT : 0));
  L.btile = TC_STAGES * L.stage;
  L.atile = L.btile + BN * TC_AROW * 2;
  L.lut_w = L.atile + (packed ? BM * TC_AROW * 2 : 0);
  L.lut_a = L.lut_w + 256 * 16;
  L.part_row = BN + 4;
  const int used = L.lut_a + (packed ? 256 * 16 : 0);
  const int part = BM * L.part_row * 4;
  L.total = used > part ? used : part;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 (or 8) bytes, or as many zero bytes when !full (the src
// is then not read; a valid address is passed all the same)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8z(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ float activate_rt(int act, float y) {
  switch (act) {
    case ACT_RELU: return activate<ACT_RELU>(y);
    case ACT_SILU: return activate<ACT_SILU>(y);
    case ACT_GELU: return activate<ACT_GELU>(y);
    default: return y;
  }
}

// out[m, n .. n + W) = act(acc + bias), W = 2 or 4 adjacent columns
template <int W>
__device__ __forceinline__ void finish_vec(const float (&acc)[W], int m, int n, int N,
                                           const float* __restrict__ bias, int act, int out_bf16,
                                           void* out) {
  float y[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    y[i] = acc[i];
    if (bias != nullptr) y[i] = __fadd_rn(y[i], bias[n + i]);
    y[i] = activate_rt(act, y[i]);
  }
  const size_t o = (size_t)m * N + n;
  if (out_bf16) {
    uint32_t w[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      memcpy(&w[i], &v, 4);
    }
    if constexpr (W == 4) *(uint2*)((__nv_bfloat16*)out + o) = make_uint2(w[0], w[1]);
    else *(uint32_t*)((__nv_bfloat16*)out + o) = w[0];
  } else {
    if constexpr (W == 4) *(float4*)((float*)out + o) = make_float4(y[0], y[1], y[2], y[3]);
    else *(float2*)((float*)out + o) = make_float2(y[0], y[1]);
  }
}

// The decode table of one operand (NNZ <= 4 values an 8-block), one
// entry a mask byte m: for each pair i of positions (2i, 2i + 1), a
// byte_perm selector (low half) that picks each position's value by its
// rank popcount(m & (2^p - 1)), clamped to NNZ - 1 like the oracle's
// gather, from the block's values (v0 | v1 << 16, v2 | v3 << 16), and one
// (high half) that keeps it, or zeroes it when bit p is clear.
__device__ __forceinline__ uint4 lut_entry(unsigned m, int nnz) {
  uint32_t e[4];
  int r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned b0 = (m >> (2 * i)) & 1u, b1 = (m >> (2 * i + 1)) & 1u;
    const int ra = min(r, nnz - 1);
    r += b0;
    const int rb = min(r, nnz - 1);
    r += b1;
    const unsigned sel = (2 * ra) | (2 * ra + 1) << 4 | (2 * rb) << 8 | (2 * rb + 1) << 12;
    const unsigned keep = (b0 ? 0x10u : 0x44u) | (b1 ? 0x3200u : 0x4400u);
    e[i] = sel | keep << 16;
  }
  return make_uint4(e[0], e[1], e[2], e[3]);
}

// One 8-block decoded to 8 bf16 (k ascending) from its values (lo = v0 |
// v1 << 16, hi = v2 | v3 << 16) and its mask's table entry: two byte
// permutes a pair of positions, no branch and no indexed register.
__device__ __forceinline__ uint4 decode8_lut(uint32_t lo, uint32_t hi, const uint4& e) {
  const uint32_t w0 = __byte_perm(__byte_perm(lo, hi, e.x & 0xFFFFu), 0u, e.x >> 16);
  const uint32_t w1 = __byte_perm(__byte_perm(lo, hi, e.y & 0xFFFFu), 0u, e.y >> 16);
  const uint32_t w2 = __byte_perm(__byte_perm(lo, hi, e.z & 0xFFFFu), 0u, e.z >> 16);
  const uint32_t w3 = __byte_perm(__byte_perm(lo, hi, e.w & 0xFFFFu), 0u, e.w >> 16);
  return make_uint4(w0, w1, w2, w3);
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// TM m-tiles of 16 rows (BM = 16 TM), BN output columns.  The 8 warps form
// a WM x WN grid over the tile: a warp owns TMW = TM / WM m-tiles and NTW
// = BN / 8 / WN n-tiles.  Grid (n_split, N tiles, M tiles), one cluster per
// output tile along x: block x sums the 8-blocks [x * kb_per_split, ...).
template <int TM, int BN, bool PACKED_A>
__global__ void __launch_bounds__(TC_THREADS, 3)
dbb_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ x_mask,
              const __nv_bfloat16* __restrict__ w_vals, const uint8_t* __restrict__ w_mask,
              const float* __restrict__ bias, void* __restrict__ out, int M, int N, int KB,
              int nnz_a, int nnz_w, int kb_per_split, int act, int out_bf16) {
  constexpr int BM = 16 * TM, NT = TC_THREADS;
  constexpr int WM = TM == 4 ? 2 : 1, WN = 8 / WM, TMW = TM / WM, NTW = BN / 8 / WN;
  constexpr int WCH = (TC_KBT * 4 * (BN / 8) + NT - 1) / NT;  // w_vals chunks a thread, at most
  constexpr int XCH = (BM * 8 + NT - 1) / NT;  // x chunks a thread, at most (8 a row)
  constexpr int BTASK = TC_KBT * BN / 2;       // B decode tasks: (8-block, column pair)
  extern __shared__ __align__(16) unsigned char smem[];
  const TcSmem L = tc_smem(BM, BN, nnz_w, nnz_a, PACKED_A);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int kb_begin = blockIdx.x * kb_per_split;
  const int nsteps = (min(KB, kb_begin + kb_per_split) - kb_begin) / TC_KBT;
  uint4* lut_w = (uint4*)(smem + L.lut_w);
  uint4* lut_a = (uint4*)(smem + L.lut_a);
  __nv_bfloat16* btile = (__nv_bfloat16*)(smem + L.btile);
  __nv_bfloat16* atile = (__nv_bfloat16*)(smem + L.atile);
  lut_w[tid] = lut_entry(tid, nnz_w);  // 256 threads, one entry each
  if (PACKED_A) lut_a[tid] = lut_entry(tid, nnz_a);

  // Each thread's chunks of a stage, worked out once (no division per
  // copy): the smem offset and the source offset from the step's base.
  // w_vals rows (8-block, slot) of BN values in 16-byte chunks; w_mask
  // rows of BN bytes in 8-byte chunks; x_vals rows of KBT * NNZa values
  // (NNZa chunks) and x_mask rows of 8 bytes, or x rows of 64 values.
  const int wrows = TC_KBT * nnz_w, wcpr = BN / 8;
  int w_so[WCH], w_go[WCH];
  unsigned w_ok = 0;
#pragma unroll
  for (int i = 0; i < WCH; ++i) {
    const int c = tid + i * NT, r = c / wcpr, cc = c % wcpr;
    w_so[i] = r < wrows ? r * BN + cc * 8 : -1;
    w_go[i] = r * N + n0 + cc * 8;
    if (r < wrows && n0 + cc * 8 < N) w_ok |= 1u << i;
  }
  const int m_r = tid / wcpr, m_c = tid % wcpr;
  const bool m_has = tid < TC_KBT * wcpr, m_ok = m_has && n0 + m_c * 8 < N;
  const int xcpr = PACKED_A ? nnz_a : 8;  // 16-byte chunks of an x row's step
  int x_so[XCH];
  long long x_go[XCH];
  unsigned x_ok = 0;
#pragma unroll
  for (int i = 0; i < XCH; ++i) {
    const int c = tid + i * NT, r = c / xcpr, cc = c % xcpr;
    x_so[i] = r < BM ? (PACKED_A ? r * TC_KBT * nnz_a + cc * 8 : r * TC_AROW + cc * 8) : -1;
    x_go[i] = PACKED_A ? (long long)(m0 + r) * KB * nnz_a + cc * 8
                       : (long long)(m0 + r) * KB * 8 + cc * 8;
    if (r < BM && m0 + r < M) x_ok |= 1u << i;
  }
  const bool xm_has = PACKED_A && tid < BM, xm_ok = xm_has && m0 + tid < M;

  auto issue = [&](int step) {  // k-step `step` of this split into its stage
    if (step < nsteps) {
      unsigned char* st = smem + (step % TC_STAGES) * L.stage;
      const int kb0 = kb_begin + step * TC_KBT;
      const __nv_bfloat16* wb = w_vals + (size_t)kb0 * nnz_w * N;
      __nv_bfloat16* wv = (__nv_bfloat16*)(st + L.wv);
#pragma unroll
      for (int i = 0; i < WCH; ++i)
        if (w_so[i] >= 0) cp_async16z(wv + w_so[i], (w_ok >> i & 1u) ? wb + w_go[i] : w_vals,
                                      w_ok >> i & 1u);
      if (m_has)
        cp_async8z(st + L.wm + m_r * BN + m_c * 8,
                   m_ok ? w_mask + (size_t)(kb0 + m_r) * N + n0 + m_c * 8 : w_mask, m_ok);
      const __nv_bfloat16* xb = x + (size_t)kb0 * (PACKED_A ? nnz_a : 8);
      __nv_bfloat16* xa = (__nv_bfloat16*)(st + L.xa);
#pragma unroll
      for (int i = 0; i < XCH; ++i)
        if (x_so[i] >= 0) cp_async16z(xa + x_so[i], (x_ok >> i & 1u) ? xb + x_go[i] : x,
                                      x_ok >> i & 1u);
      if (xm_has)
        cp_async8z(st + L.xm + tid * TC_KBT,
                   xm_ok ? x_mask + (size_t)(m0 + tid) * KB + kb0 : x_mask, xm_ok);
    }
    cp_commit();
  };

  float acc[TMW][NTW][4];
#pragma unroll
  for (int a = 0; a < TMW; ++a)
#pragma unroll
    for (int b = 0; b < NTW; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.0f;

  const int g = lane / 4, t = lane % 4;
  const int wmi = warp / WN, wni = warp % WN;
  // ldmatrix addresses: A rows of this warp's m-tiles (lanes 0-15 at k,
  // 16-31 at k + 8); B rows (columns of W) of its n-tiles, two n-tiles an
  // x4 (lanes 0-7 / 8-15: n-tile j at k / k + 8, 16-31: n-tile j + 1)
  const int a_off = (wmi * TMW * 16 + lane % 16) * TC_AROW + (lane / 16) * 8;
  const __nv_bfloat16* bb0 =
      btile + (wni * NTW * 8 + lane % 8 + (lane / 16) * 8) * TC_AROW + ((lane / 8) % 2) * 8;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) issue(s);

  for (int s = 0; s < nsteps; ++s) {
    cp_wait<TC_STAGES - 2>();  // step s landed (this thread's copies) ...
    __syncthreads();           // ... everyone's; step s - 1's tiles fully consumed
    issue(s + TC_STAGES - 1);
    const unsigned char* st = smem + (s % TC_STAGES) * L.stage;
    // weights -> the dense B tile: a task is one 8-block of two adjacent
    // columns, its values read as column pairs (one word a slot)
    const uint32_t* wv32 = (const uint32_t*)(st + L.wv);
    const uint16_t* wm16 = (const uint16_t*)(st + L.wm);
#pragma unroll
    for (int q = tid; q < BTASK; q += NT) {
      const int kb = q / (BN / 2), c = (q % (BN / 2)) * 2;
      const uint32_t* src = wv32 + (kb * nnz_w * BN + c) / 2;
      uint32_t u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = j < nnz_w ? src[j * (BN / 2)] : 0u;
      const unsigned m2 = wm16[(kb * BN + c) / 2];
      const uint32_t lo0 = __byte_perm(u[0], u[1], 0x5410), hi0 = __byte_perm(u[2], u[3], 0x5410);
      const uint32_t lo1 = __byte_perm(u[0], u[1], 0x7632), hi1 = __byte_perm(u[2], u[3], 0x7632);
      *(uint4*)(btile + c * TC_AROW + kb * 8) = decode8_lut(lo0, hi0, lut_w[m2 & 0xFFu]);
      *(uint4*)(btile + (c + 1) * TC_AROW + kb * 8) = decode8_lut(lo1, hi1, lut_w[m2 >> 8]);
    }
    const __nv_bfloat16* at;
    if constexpr (PACKED_A) {
      // activations -> the A tile: one (row, 8-block) a task
      const uint8_t* xm = st + L.xm;
      const __nv_bfloat16* xv = (const __nv_bfloat16*)(st + L.xa);
      for (int p = tid; p < BM * TC_KBT; p += NT) {
        uint32_t lo, hi;
        if (nnz_a == 4) {
          const uint2 v = *(const uint2*)(xv + p * 4);
          lo = v.x;
          hi = v.y;
        } else {
          const uint16_t* v = (const uint16_t*)(xv + p * nnz_a);
          uint32_t u[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) u[j] = j < nnz_a ? v[j] : 0u;
          lo = u[0] | u[1] << 16;
          hi = u[2] | u[3] << 16;
        }
        *(uint4*)(atile + (p / TC_KBT) * TC_AROW + (p % TC_KBT) * 8) =
            decode8_lut(lo, hi, lut_a[xm[p]]);
      }
      at = atile;
    } else {
      at = (const __nv_bfloat16*)(st + L.xa);
    }
    __syncthreads();  // the step's tiles are decoded
#pragma unroll
    for (int kk = 0; kk < TC_KBT / 2; ++kk) {  // four 16-deep k-steps
      uint32_t a[TMW][4];
#pragma unroll
      for (int i = 0; i < TMW; ++i) ldsm_x4(a[i], at + a_off + i * 16 * TC_AROW + kk * 16);
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        uint32_t b[4];
        if constexpr (NTW == 1) ldsm_x2(b, bb0 + kk * 16);
        else ldsm_x4(b, bb0 + j * 8 * TC_AROW + kk * 16);
#pragma unroll
        for (int i = 0; i < TMW; ++i) {
          mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[0], b[1]);
          if constexpr (NTW > 1)
            mma_bf16(acc[i][j + 1], a[i][0], a[i][1], a[i][2], a[i][3], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // this thread's outputs: rows (wmi * TMW + i) * 16 + g (+ 8), columns
  // (wni * NTW + j) * 8 + 2t (+ 1) of the tile
  const int n_split = gridDim.x;
  if (n_split == 1) {  // the whole K range: finish from the registers
#pragma unroll
    for (int i = 0; i < TMW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + (wmi * TMW + i) * 16 + g + 8 * h;
          const int n = n0 + (wni * NTW + j) * 8 + 2 * t;
          if (m < M && n < N) {
            const float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
            finish_vec<2>(v, m, n, N, bias, act, out_bf16, out);
          }
        }
    return;
  }

  // Split-K: each block's f32 partial into its own shared memory; after
  // the cluster's barrier block x sums its share of the tile's outputs over
  // the n_split partials through distributed shared memory, in split order
  // (rank 0, 1, ...: the K ranges in order), then finishes them.
  __syncthreads();  // the ring's last reads are done before it is overwritten
  float* part = (float*)smem;
  const int PR = L.part_row;
#pragma unroll
  for (int i = 0; i < TMW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *(float2*)(part + ((wmi * TMW + i) * 16 + g + 8 * h) * PR + (wni * NTW + j) * 8 + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int rows = min(BM, M - m0), q4 = min(BN, N - n0) / 4;  // float4 groups of a row
  const int total = rows * q4, per = (total + n_split - 1) / n_split;
  const int q_end = min(total, (rank + 1) * per);
  for (int q = rank * per + tid; q < q_end; q += NT) {
    const int r = q / q4, c = (q % q4) * 4;
    const int off = r * PR + c;
    float4 sum = *(const float4*)(cluster.map_shared_rank(part, 0) + off);
    for (int j = 1; j < n_split; ++j) {
      const float4 v = *(const float4*)(cluster.map_shared_rank(part, j) + off);
      sum.x = __fadd_rn(sum.x, v.x);
      sum.y = __fadd_rn(sum.y, v.y);
      sum.z = __fadd_rn(sum.z, v.z);
      sum.w = __fadd_rn(sum.w, v.w);
    }
    const float v4[4] = {sum.x, sum.y, sum.z, sum.w};
    finish_vec<4>(v4, m0 + r, n0 + c, N, bias, act, out_bf16, out);
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <int TM, int BN, bool PACKED_A>
cudaError_t launch_tc(const void* x, const uint8_t* xm, const void* wv, const uint8_t* wm,
                      const float* bias, void* out, int M, int N, int KB, int nnz_a, int nnz_w,
                      int kb_per_split, int n_split, int act, int out_bf16, cudaStream_t st) {
  auto kernel = dbb_tc_kernel<TM, BN, PACKED_A>;
  const int smem = tc_smem(16 * TM, BN, nnz_w, nnz_a, PACKED_A).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, (N + BN - 1) / BN, (M + 16 * TM - 1) / (16 * TM));
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)x, xm, (const __nv_bfloat16*)wv,
                           wm, bias, out, M, N, KB, nnz_a, nnz_w, kb_per_split, act, out_bf16);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool PACKED_A>
cudaError_t launch_tc_for(int bn, const void* x, const uint8_t* xm, const void* wv,
                          const uint8_t* wm, const float* bias, void* out, int M, int N, int KB,
                          int nnz_a, int nnz_w, int kb_per_split, int n_split, int act,
                          int out_bf16, cudaStream_t st) {
#define TC_ARGS x, xm, wv, wm, bias, out, M, N, KB, nnz_a, nnz_w, kb_per_split, n_split, act, \
    out_bf16, st
  if (M <= 16)
    return bn == 128 ? launch_tc<1, 128, PACKED_A>(TC_ARGS) : launch_tc<1, 64, PACKED_A>(TC_ARGS);
  return bn == 128 ? launch_tc<4, 128, PACKED_A>(TC_ARGS) : launch_tc<4, 64, PACKED_A>(TC_ARGS);
#undef TC_ARGS
}

struct Args {
  const void* x;
  const uint8_t* xm;
  const void* wv;
  const uint8_t* wm;
  const float* bias;
  void* out;
  float* part;
  int M, N, KB, nnz_a, nnz_w, kb_per_split, n_split;
};

template <bool SPLIT, bool BF16, int TM, bool PACKED_A, typename OutT, int ACT>
cudaError_t launch_main(const Args& a, cudaStream_t st) {
  if constexpr (BF16) {
    dim3 grid((a.N + BN - 1) / BN, (a.M + 16 * TM - 1) / (16 * TM), a.n_split);
    dbb_bf16_kernel<TM, PACKED_A, SPLIT, OutT, ACT><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a.x, a.xm, (const __nv_bfloat16*)a.wv, a.wm, a.bias, (OutT*)a.out,
        a.part, a.M, a.N, a.KB, a.nnz_a, a.nnz_w, a.kb_per_split);
  } else {
    dim3 grid((a.N + BN - 1) / BN, (a.M + 63) / 64, a.n_split);
    dbb_f32_kernel<PACKED_A, SPLIT, OutT, ACT><<<grid, THREADS, 0, st>>>(
        (const float*)a.x, a.xm, (const float*)a.wv, a.wm, a.bias, (OutT*)a.out, a.part, a.M,
        a.N, a.KB, a.nnz_a, a.nnz_w, a.kb_per_split);
  }
  return cudaGetLastError();
}

template <bool BF16, int TM, bool PACKED_A, typename OutT, int ACT>
cudaError_t launch_split(const Args& a, cudaStream_t st) {
  if (a.n_split == 1) return launch_main<false, BF16, TM, PACKED_A, OutT, ACT>(a, st);
  cudaError_t err = launch_main<true, BF16, TM, PACKED_A, OutT, ACT>(a, st);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)a.M * a.N;
  reduce_kernel<OutT, ACT><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      a.part, a.n_split, a.bias, (OutT*)a.out, a.M, a.N);
  return cudaGetLastError();
}

template <bool BF16, int TM, bool PACKED_A, typename OutT>
cudaError_t launch_act(int act, const Args& a, cudaStream_t st) {
  switch (act) {
    case ACT_NONE: return launch_split<BF16, TM, PACKED_A, OutT, ACT_NONE>(a, st);
    case ACT_RELU: return launch_split<BF16, TM, PACKED_A, OutT, ACT_RELU>(a, st);
    case ACT_SILU: return launch_split<BF16, TM, PACKED_A, OutT, ACT_SILU>(a, st);
    case ACT_GELU: return launch_split<BF16, TM, PACKED_A, OutT, ACT_GELU>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PACKED_A, typename OutT>
cudaError_t launch_type(int bf16, int act, const Args& a, cudaStream_t st) {
  if (!bf16) return launch_act<false, 4, PACKED_A, OutT>(act, a, st);
  if (a.M <= 16) return launch_act<true, 1, PACKED_A, OutT>(act, a, st);
  return launch_act<true, 4, PACKED_A, OutT>(act, a, st);
}

}  // namespace

// C entry point, bound with ctypes (kernels/dbb_matmul.py).  Every pointer
// and the stream are void*; sizes are int.  packed_a selects kernel #4 (x
// = x_vals [M, KB, nnz_a], x_mask [M, KB] given) over kernel #1 (x = dense
// [M, KB*8], x_mask NULL, 16-byte aligned).  x and w_vals are bf16
// (bf16 != 0) or f32; bias (f32 [N]) may be NULL.  The K range splits into
// n_split ranges of kb_per_split 8-blocks.  body 1 runs the tc body (bf16
// only; N % 8 == 0, KB % 8 == 0, kb_per_split % 8 == 0, n_split <= 8, bn
// 64 or 128, x and w_vals 16-byte and the masks 8-byte aligned; no
// scratch), body 0 the generic body (bf16 or f32; n_split > 1 needs part,
// f32 [n_split, M, N] scratch, and a second launch).  Returns
// cudaGetLastError() after the launches; cudaErrorInvalidValue for
// arguments the chosen body does not take.
extern "C" int dbb_matmul_native(const void* x, const void* x_mask, const void* w_vals,
                                 const void* w_mask, const void* bias, void* out, void* part,
                                 int M, int N, int KB, int nnz_a, int nnz_w, int kb_per_split,
                                 int n_split, int packed_a, int bf16, int out_bf16, int act,
                                 int body, int bn, void* stream) {
  if (M <= 0 || N <= 0 || KB <= 0 || nnz_w < 1 || nnz_w > 8 ||
      (packed_a && (nnz_a < 1 || nnz_a > 8)) || n_split < 1 || kb_per_split < 1 ||
      (long long)kb_per_split * n_split < KB || act < ACT_NONE || act > ACT_GELU)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)w_vals % 16 == 0 &&
                         (uintptr_t)w_mask % 8 == 0 && (!packed_a || (uintptr_t)x_mask % 8 == 0);
    if (!bf16 || N % 8 || KB % TC_KBT || kb_per_split % TC_KBT || n_split > TC_MAX_SPLIT ||
        nnz_w > 4 || (packed_a && nnz_a > 4) ||
        (long long)kb_per_split * (n_split - 1) >= KB || (bn != 64 && bn != 128) || !aligned)
      return (int)cudaErrorInvalidValue;
    const auto launch = packed_a ? launch_tc_for<true> : launch_tc_for<false>;
    return (int)launch(bn, x, (const uint8_t*)x_mask, w_vals, (const uint8_t*)w_mask,
                       (const float*)bias, out, M, N, KB, nnz_a, nnz_w, kb_per_split, n_split,
                       act, out_bf16, s);
  }
  if (body != 0 || (n_split > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{x, (const uint8_t*)x_mask, w_vals, (const uint8_t*)w_mask, (const float*)bias,
               out, (float*)part, M, N, KB, nnz_a, nnz_w, kb_per_split, n_split};
  cudaError_t err;
  if (packed_a) {
    err = out_bf16 ? launch_type<true, __nv_bfloat16>(bf16, act, a, s)
                   : launch_type<true, float>(bf16, act, a, s);
  } else {
    err = out_bf16 ? launch_type<false, __nv_bfloat16>(bf16, act, a, s)
                   : launch_type<false, float>(bf16, act, a, s);
  }
  return (int)err;
}
