// INT8 DBB matmuls for Hopper (sm_90a): the W-DBB kernel and the joint
// A/W-DBB kernel, one templated body.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/dbb_matmul.py::dbb_matmul_int8_pallas     (_dbb_matmul_int8_kernel)
//   repro/kernels/dbb_matmul.py::dbb_matmul_aw_int8_pallas  (_dbb_matmul_aw_int8_kernel)
// and computes, bit for bit, their oracles in kernels/ref.py:
//   out[m, n] = act(float(acc[m, n]) * (x_scale[m] * w_scale[n]) + bias[n])
//   acc       = sum_k decode_a(x)[m, k] * decode_w(w)[k, n]      (int32, exact)
//
// What bounds it on the H100.  At the serving shapes (M = max_batch = 4 on
// decode, M = 64 on a mixed prefill step, K up to 12800, N up to 49408) the
// work is the packed weight stream: 0.625 bytes per weight element at 4/8
// (NNZ int8 values + one mask byte per 8-block) against 2*M operations per
// weight element, far below the card's 590 int8 operations per byte.  So
// the bound is bytes (device memory at 3.35 TB/s), not operations.
//
// What the design does about it.  Weights cross device memory once, in
// the packed wire format, and are rank-decoded in shared memory, never
// written back dense:  dense[b] = bit_b ? vals[popcount(mask & (2^b-1))] : 0.
// One thread decodes one 8-block of four adjacent columns from 32-bit
// loads (one mask word, NNZ value words) into int8 lanes, so the decode
// costs a few loads per 32 weights.  The product runs on the int8 tensor
// cores (mma.sync m16n8k32, int32 accumulate) straight out of shared
// memory, whose rows hold 4 consecutive k per 32-bit word — the fragment
// layout of the instruction — with a 4-word pad against bank conflicts.
// A block owns a BM x 64 output tile and loops over K in 128-deep steps;
// when the (M, N) tiles alone cannot fill 132 SMs the K loop is split
// across blocks that add their partial sums into an int32 workspace with
// atomics (integer addition is exact in any order, so the result stays
// bit-identical), and a second kernel runs the epilogue.
// Not yet done: cp.async/TMA double buffering and wgmma.
//
// The epilogue follows the oracle's order exactly (ref.combined_scale then
// epilogue.apply_dequant_epilogue): s = x_scale * w_scale first, then
// float(acc) * s, then + bias, then the activation, then the output cast,
// with __fmul_rn/__fadd_rn so that nvcc contracts nothing into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;            // output columns per block
constexpr int BK = 128;           // reduction depth per shared-memory step
constexpr int KBT = BK / 8;       // 8-blocks per step
constexpr int KW = BK / 4 + 4;    // int32 words per shared row (+4: no bank conflicts)
constexpr int THREADS = 256;      // 8 warps

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

// Rank-decode one 8-block into two little-endian words of int8 lanes.
// slot(j) returns value slot j; slots past nnz-1 clamp like the oracle.
template <typename Slot>
__device__ __forceinline__ void decode8(unsigned mask, int nnz, Slot slot, uint32_t& lo,
                                        uint32_t& hi) {
  lo = 0u;
  hi = 0u;
  int r = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if ((mask >> b) & 1u) {
      const uint32_t v = slot(r < nnz - 1 ? r : nnz - 1);
      if (b < 4) lo |= v << (8 * b);
      else hi |= v << (8 * (b - 4));
      ++r;
    }
  }
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

// out[m, n] from the exact accumulator: the oracle's epilogue
template <typename OutT, int ACT>
__device__ __forceinline__ void finish(int acc, int m, int n, int N, const float* x_scale,
                                       int per_row, const float* w_scale, const float* bias,
                                       OutT* out, int32_t* acc_out) {
  if (acc_out != nullptr) acc_out[(size_t)m * N + n] = acc;
  const float s = __fmul_rn(x_scale[per_row ? m : 0], w_scale[n]);
  float y = __fmul_rn(__int2float_rn(acc), s);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  store(out + (size_t)m * N + n, activate<ACT>(y));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// TM: 16-row tiles per block (BM = 16 * TM).  8 warps split the block's
// TM x 8 grid of 16x8 tiles: warp w takes row tile w % TM and the
// NT = 8 * TM / 8 column tiles starting at (w / TM) * NT.
// PACKED_A: x is x_vals [M, KB, nnz_a] + x_mask [M, KB] (kernel #3);
// otherwise x is dense x_q [M, K] (kernel #2).
// SPLIT: add the partial sums of this block's K range into acc_ws.
template <int TM, bool PACKED_A, bool SPLIT, typename OutT, int ACT>
__global__ void __launch_bounds__(THREADS)
dbb_int8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ x_mask,
                const float* __restrict__ x_scale, int x_scale_per_row,
                const int8_t* __restrict__ w_vals, const uint8_t* __restrict__ w_mask,
                const float* __restrict__ w_scale, const float* __restrict__ bias,
                OutT* __restrict__ out, int32_t* __restrict__ acc_out,
                int32_t* __restrict__ acc_ws, int M, int N, int KB, int nnz_a, int nnz_w,
                int kb_per_split) {
  constexpr int BM = 16 * TM;
  constexpr int NT = TM;  // 8-column tiles per warp: 8 * TM tiles over 8 warps
  __shared__ uint32_t xs[BM][KW];
  __shared__ uint32_t ws[BN][KW];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp % TM) * 16, wn = (warp / TM) * NT * 8;
  const int K = KB * 8;
  const int kb_begin = blockIdx.z * kb_per_split;
  const int kb_end = min(KB, kb_begin + kb_per_split);

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int kb0 = kb_begin; kb0 < kb_end; kb0 += KBT) {
    // weight tile: one thread per (8-block, 4 adjacent columns)
    for (int p = tid; p < (BN / 4) * KBT; p += THREADS) {
      const int n4 = (p % (BN / 4)) * 4, bb = p / (BN / 4);
      const int n = n0 + n4, kb = kb0 + bb;
      uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
      if (n < N && kb < kb_end) {
        const uint32_t masks = *(const uint32_t*)(w_mask + (size_t)kb * N + n);
        const int8_t* base = w_vals + (size_t)kb * nnz_w * N + n;
        uint32_t vals[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          vals[j] = j < nnz_w ? *(const uint32_t*)(base + (size_t)j * N) : 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          decode8((masks >> (8 * c)) & 0xFFu, nnz_w,
                  [&](int j) { return (vals[j] >> (8 * c)) & 0xFFu; }, lo[c], hi[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ws[n4 + c][2 * bb] = lo[c];
        ws[n4 + c][2 * bb + 1] = hi[c];
      }
    }
    // activation tile
    for (int p = tid; p < BM * KBT; p += THREADS) {
      const int mm = p / KBT, bb = p % KBT;
      const int m = m0 + mm, kb = kb0 + bb;
      uint32_t lo = 0u, hi = 0u;
      if (m < M && kb < kb_end) {
        if (PACKED_A) {
          const int8_t* v = x + ((size_t)m * KB + kb) * nnz_a;
          decode8(x_mask[(size_t)m * KB + kb], nnz_a,
                  [&](int j) { return (uint32_t)(uint8_t)v[j]; }, lo, hi);
        } else {
          const int8_t* src = x + (size_t)m * K + (size_t)kb * 8;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            lo |= (uint32_t)(uint8_t)src[b] << (8 * b);
            hi |= (uint32_t)(uint8_t)src[b + 4] << (8 * b);
          }
        }
      }
      xs[mm][2 * bb] = lo;
      xs[mm][2 * bb + 1] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK / 4; kw += 8) {  // 32-deep k slices
      const uint32_t a0 = xs[wm + g][kw + t], a1 = xs[wm + g + 8][kw + t];
      const uint32_t a2 = xs[wm + g][kw + t + 4], a3 = xs[wm + g + 8][kw + t + 4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nc = wn + j * 8 + g;
        mma_s8(acc[j], a0, a1, a2, a3, ws[nc][kw + t], ws[nc][kw + t + 4]);
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
      if (SPLIT) atomicAdd(acc_ws + (size_t)m * N + n, acc[j][i]);
      else finish<OutT, ACT>(acc[j][i], m, n, N, x_scale, x_scale_per_row, w_scale, bias,
                             out, acc_out);
    }
  }
}

// The epilogue of a split-K launch, one thread per output.
template <typename OutT, int ACT>
__global__ void __launch_bounds__(THREADS)
epilogue_kernel(const int32_t* __restrict__ acc_ws, const float* __restrict__ x_scale,
                int per_row, const float* __restrict__ w_scale,
                const float* __restrict__ bias, OutT* __restrict__ out,
                int32_t* __restrict__ acc_out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)M * N) return;
  finish<OutT, ACT>(acc_ws[i], (int)(i / N), (int)(i % N), N, x_scale, per_row, w_scale,
                    bias, out, acc_out);
}

struct Args {
  const int8_t* x;
  const uint8_t* xm;
  const float* xsc;
  int per_row;
  const int8_t* wv;
  const uint8_t* wm;
  const float* wsc;
  const float* bias;
  void* out;
  int32_t* acc_out;
  int32_t* acc_ws;
  int M, N, KB, nnz_a, nnz_w, split_k;
};

template <int TM, bool PACKED_A, bool SPLIT, typename OutT, int ACT>
cudaError_t launch_one(const Args& a, cudaStream_t st) {
  const int kb_per_split = ((a.KB + a.split_k - 1) / a.split_k + KBT - 1) / KBT * KBT;
  const int nz = (a.KB + kb_per_split - 1) / kb_per_split;
  dim3 grid((a.N + BN - 1) / BN, (a.M + 16 * TM - 1) / (16 * TM), nz);
  dbb_int8_kernel<TM, PACKED_A, SPLIT, OutT, ACT><<<grid, THREADS, 0, st>>>(
      a.x, a.xm, a.xsc, a.per_row, a.wv, a.wm, a.wsc, a.bias, (OutT*)a.out, a.acc_out,
      a.acc_ws, a.M, a.N, a.KB, a.nnz_a, a.nnz_w, kb_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return err;
  const size_t total = (size_t)a.M * a.N;
  epilogue_kernel<OutT, ACT><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      a.acc_ws, a.xsc, a.per_row, a.wsc, a.bias, (OutT*)a.out, a.acc_out, a.M, a.N);
  return cudaGetLastError();
}

template <int TM, bool PACKED_A, typename OutT, int ACT>
cudaError_t launch_split(const Args& a, cudaStream_t st) {
  if (a.split_k > 1) {
    cudaError_t err = cudaMemsetAsync(a.acc_ws, 0, sizeof(int32_t) * a.M * a.N, st);
    if (err != cudaSuccess) return err;
    return launch_one<TM, PACKED_A, true, OutT, ACT>(a, st);
  }
  return launch_one<TM, PACKED_A, false, OutT, ACT>(a, st);
}

template <int TM, bool PACKED_A, typename OutT>
cudaError_t launch_act(int act, const Args& a, cudaStream_t st) {
  switch (act) {
    case ACT_NONE: return launch_split<TM, PACKED_A, OutT, ACT_NONE>(a, st);
    case ACT_RELU: return launch_split<TM, PACKED_A, OutT, ACT_RELU>(a, st);
    case ACT_SILU: return launch_split<TM, PACKED_A, OutT, ACT_SILU>(a, st);
    case ACT_GELU: return launch_split<TM, PACKED_A, OutT, ACT_GELU>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PACKED_A, typename OutT>
cudaError_t launch_tm(int act, const Args& a, cudaStream_t st) {
  if (a.M <= 16) return launch_act<1, PACKED_A, OutT>(act, a, st);
  return launch_act<4, PACKED_A, OutT>(act, a, st);
}

}  // namespace

// Output tiles a launch has for (M, N): the wrapper picks split_k from it.
extern "C" int dbb_matmul_int8_tiles(int M, int N) {
  return ((N + BN - 1) / BN) * (M <= 16 ? (M + 15) / 16 : (M + 63) / 64);
}

// C entry point, bound with ctypes (kernels/dbb_matmul.py).  Every pointer
// and the stream are void*; sizes are int.  packed_a selects kernel #3
// (x = x_vals, x_mask given) over kernel #2 (x = dense x_q, x_mask NULL).
// bias and acc_out may be NULL.  N must be a multiple of 4 and w_vals,
// w_mask 4-byte aligned.  split_k > 1 needs acc_ws, int32 [M, N] scratch.
// Returns cudaGetLastError() after the launches.
extern "C" int dbb_matmul_int8(const void* x, const void* x_mask, const void* x_scale,
                               int x_scale_per_row, const void* w_vals, const void* w_mask,
                               const void* w_scale, const void* bias, void* out,
                               void* acc_out, void* acc_ws, int M, int N, int KB, int nnz_a,
                               int nnz_w, int split_k, int packed_a, int out_bf16, int act,
                               void* stream) {
  if (M <= 0 || N <= 0 || KB <= 0 || N % 4 != 0 || split_k < 1 ||
      (split_k > 1 && acc_ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int8_t*)x, (const uint8_t*)x_mask, (const float*)x_scale,
               x_scale_per_row, (const int8_t*)w_vals, (const uint8_t*)w_mask,
               (const float*)w_scale, (const float*)bias, out, (int32_t*)acc_out,
               (int32_t*)acc_ws, M, N, KB, nnz_a, nnz_w, split_k};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (packed_a) {
    err = out_bf16 ? launch_tm<true, __nv_bfloat16>(act, a, s) : launch_tm<true, float>(act, a, s);
  } else {
    err = out_bf16 ? launch_tm<false, __nv_bfloat16>(act, a, s) : launch_tm<false, float>(act, a, s);
  }
  return (int)err;
}
