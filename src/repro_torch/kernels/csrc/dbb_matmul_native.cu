// Native-wire DBB matmuls for Hopper (sm_90a): the W-DBB kernel (#1) and
// the joint A/W-DBB kernel (#4), one templated body.
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
// operations per weight element, far below the card's ~295 bf16
// operations per byte.  So the bound is bytes (3.35 TB/s), not operations.
//
// What the design does about it.  Weights cross device memory once, in the
// packed wire format, and are rank-decoded in shared memory, never written
// back dense:  dense[b] = bit_b ? vals[popcount(mask & (2^b-1))] : 0.
// One thread decodes one 8-block of four adjacent columns (one mask word,
// NNZ loads of four values) into shared rows of k-consecutive values.
// bf16 operands multiply on the tensor cores (mma.sync m16n8k16, f32
// accumulate) straight out of shared memory, whose rows hold 2
// consecutive k per 32-bit word — the fragment layout of the instruction
// — with a 4-word pad against bank conflicts.  Every bf16 product is
// exact in f32, so only the order of the sums differs from the oracle.
// f32 operands multiply with scalar FFMA (never TF32: the oracle is full
// f32).  A block owns a BM x 64 output tile and loops over K in BK-deep
// steps.
//
// Determinism.  The K range of an output element is cut into splits whose
// count the caller derives from (K, N) only, never from M; each split
// sums its k in ascending order, and a second kernel adds the splits'
// f32 partials from a workspace in split order before the epilogue.  No
// float atomics: a row's output is bitwise the same whatever M or the
// other rows are, so batch invariance holds on the card.
// Not yet done: cp.async/TMA double buffering and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// Reduction depth of one shared-memory step (in 8-blocks) for bf16 (else
// f32) operands: the wrapper cuts K into splits of whole steps.
extern "C" int dbb_matmul_native_step_blocks(int bf16) {
  return bf16 ? Tile<__nv_bfloat16>::BK / 8 : Tile<float>::BK / 8;
}

// C entry point, bound with ctypes (kernels/dbb_matmul.py).  Every pointer
// and the stream are void*; sizes are int.  packed_a selects kernel #4 (x
// = x_vals [M, KB, nnz_a], x_mask [M, KB] given) over kernel #1 (x = dense
// [M, KB*8], x_mask NULL, 16-byte aligned).  x and w_vals are bf16
// (bf16 != 0) or f32; bias (f32 [N]) may be NULL.  The K range splits into
// n_split ranges of kb_per_split 8-blocks (a multiple of the step depth);
// n_split > 1 needs part, f32 [n_split, M, N] scratch.  Returns
// cudaGetLastError() after the launches.
extern "C" int dbb_matmul_native(const void* x, const void* x_mask, const void* w_vals,
                                 const void* w_mask, const void* bias, void* out, void* part,
                                 int M, int N, int KB, int nnz_a, int nnz_w, int kb_per_split,
                                 int n_split, int packed_a, int bf16, int out_bf16, int act,
                                 void* stream) {
  if (M <= 0 || N <= 0 || KB <= 0 || nnz_w < 1 || nnz_w > 8 || (packed_a && (nnz_a < 1 || nnz_a > 8)) ||
      n_split < 1 || kb_per_split < 1 || (long long)kb_per_split * n_split < KB ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, (const uint8_t*)x_mask, w_vals, (const uint8_t*)w_mask, (const float*)bias,
               out, (float*)part, M, N, KB, nnz_a, nnz_w, kb_per_split, n_split};
  cudaStream_t s = (cudaStream_t)stream;
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
