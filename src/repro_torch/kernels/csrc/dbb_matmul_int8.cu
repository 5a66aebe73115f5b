// INT8 DBB matmuls for Hopper (sm_90a): the W-DBB kernel (#2) and the joint
// A/W-DBB kernel (#3), two bodies each.
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
// weight element, at M = 64 about 205 operations per byte against the
// card's 590.  So the bound is bytes (device memory at 3.35 TB/s), and
// mma.sync on the int8 tensor cores keeps up: wgmma is not needed.
//
// Two bodies.  Every call whose shape it takes runs the tc body
// (dbb_int8_tc_kernel, counted in INT8_TC / AW_INT8_TC by the wrapper):
// K % 128 == 0, N % 16 == 0, NNZ <= 4 on both operands, 16-byte aligned
// operands.  Other shapes run the generic body (dbb_int8_generic_kernel),
// the port's first: synchronous loads (byte loads with a guarded column tail
// where N % 4 != 0), a branchy decode into shared rows, and for split-K an
// int32 workspace (memset, atomics, a second epilogue launch).
// Integer sums are exact in any order, so both give the oracle's bits at
// any split and any M.
//
// The tc body.  A block owns a BM x 128 output tile (BM 16 rows up to M =
// 16, else 64) and one K split, in k-steps of 16 8-blocks (128 k):
// - A ring of TC_STAGES k-steps in shared memory, filled by cp.async with
//   the operands as they lie in device memory: w_vals [16][NNZw][BN],
//   w_mask [16][BN], and x_vals [BM][16 * NNZa] with x_mask [BM][16] (#3)
//   or x_q [BM][128] (#2).  Each thread's 16-byte chunks are worked out
//   once; rows past M and columns past N are zero-filled by the copy's
//   source size.  The next steps are in flight while one is decoded and
//   multiplied; one barrier a step.
// - Decoding straight into mma.sync.m16n8k32 fragments, no dense tile.  An
//   int8 8-block of NNZ <= 4 values is one 32-bit word; a 256-entry table
//   (built on the host, uploaded once per device, copied into shared
//   memory with the first step) maps its mask byte to two byte_perm
//   selectors that give its dense low word (k 0-3) and high word (k 4-7),
//   a zero lane from a zero word, ranks past NNZ - 1 clamped like the
//   oracle: two prmt an 8-block, no branch, no popcount, no indexed
//   register.  Inside each 32-deep slice the body permutes k the same way
//   for both operands (exact: integer sums): lane t of a quad holds
//   8-block t, its low word where the fragment expects k 4t..4t+3 and its
//   high word where it expects 16+4t..16+4t+3.  So a0/a1 (rows g, g+8)
//   and b0 are low words, a2/a3 and b1 high words, and each thread decodes
//   its own fragments from the raw stage.
// - A warp owns 32 columns, lane group g the 4 adjacent columns 4g..4g+3
//   (n-tile j's fragment column g is column 4g + j): one 32-bit load a
//   value slot reads the 4 columns' slot, and 8 prmt transpose 4 slots x 4
//   columns into 4 column words.  Weight rows are stored with their 16-byte
//   chunks XOR-swizzled by the 8-block's quad, so the 32 lanes' loads hit
//   32 banks.  The C fragment then gives a thread 8 consecutive columns of
//   a row.
// - 8 warps = WM x 4 x WK: WM warps over the m-tiles (2 of 64 rows, 1 of
//   16), 4 over the 32-column strips, WK over the four slices of a step (2
//   for 16 rows: an in-block K split, summed in shared memory at the end).
//   A weight 8-block is decoded by the WM warps of its strip, an
//   activation 8-block by the 4 strips' warps: decoding the activations
//   once a step into a dense tile (a second barrier a step), or the
//   weights once (WM = 1, 128 registers with spills), measured slower or
//   within 1% (PERF.md).
// - Split-K in one launch: the n_split blocks of an output tile (at most 8)
//   are one thread-block cluster.  Each puts its int32 partial tile in its
//   own shared memory; after the cluster's barrier each block sums a share
//   of the tile over the cluster through distributed shared memory and
//   runs the epilogue on it.  No workspace, no memset, no second launch.
//
// The epilogue follows the oracle's order exactly (ref.combined_scale then
// epilogue.apply_dequant_epilogue): s = x_scale * w_scale first, then
// float(acc) * s, then + bias, then the activation, then the output cast,
// with __fmul_rn/__fadd_rn so that nvcc contracts nothing into an FMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

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

__device__ __forceinline__ float activate_rt(int act, float y) {
  switch (act) {
    case ACT_RELU: return activate<ACT_RELU>(y);
    case ACT_SILU: return activate<ACT_SILU>(y);
    case ACT_GELU: return activate<ACT_GELU>(y);
    default: return y;
  }
}

__device__ __forceinline__ void store(float* p, float y) { *p = y; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float y) { *p = __float2bfloat16_rn(y); }

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The generic body (the port's first; shapes the tc body does not take).

constexpr int BN = 64;            // output columns per block
constexpr int BK = 128;           // reduction depth per shared-memory step
constexpr int KBT = BK / 8;       // 8-blocks per step
constexpr int KW = BK / 4 + 4;    // int32 words per shared row (+4: no bank conflicts)
constexpr int THREADS = 256;      // 8 warps

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

// TM: 16-row tiles per block (BM = 16 * TM).  8 warps split the block's
// TM x 8 grid of 16x8 tiles: warp w takes row tile w % TM and the
// NT = 8 * TM / 8 column tiles starting at (w / TM) * NT.
// PACKED_A: x is x_vals [M, KB, nnz_a] + x_mask [M, KB] (kernel #3);
// otherwise x is dense x_q [M, K] (kernel #2).
// SPLIT: add the partial sums of this block's K range into acc_ws.
template <int TM, bool PACKED_A, bool SPLIT, typename OutT, int ACT>
__global__ void __launch_bounds__(THREADS)
dbb_int8_generic_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ x_mask,
                        const float* __restrict__ x_scale, int x_scale_per_row,
                        const int8_t* __restrict__ w_vals, const uint8_t* __restrict__ w_mask,
                        const float* __restrict__ w_scale, const float* __restrict__ bias,
                        OutT* __restrict__ out, int32_t* __restrict__ acc_out,
                        int32_t* __restrict__ acc_ws, int M, int N, int KB, int nnz_a,
                        int nnz_w, int kb_per_split) {
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
  // 4 columns in one 32-bit load where every weight row is 4-byte aligned;
  // otherwise (N % 4 != 0) byte loads with a guarded tail of columns, the
  // columns past N decoding to zero (mask 0)
  const bool vec = (N & 3) == 0 && ((uintptr_t)w_vals & 3) == 0 && ((uintptr_t)w_mask & 3) == 0;

  for (int kb0 = kb_begin; kb0 < kb_end; kb0 += KBT) {
    // weight tile: one thread per (8-block, 4 adjacent columns)
    for (int p = tid; p < (BN / 4) * KBT; p += THREADS) {
      const int n4 = (p % (BN / 4)) * 4, bb = p / (BN / 4);
      const int n = n0 + n4, kb = kb0 + bb;
      uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
      if (n < N && kb < kb_end) {
        const uint8_t* mrow = w_mask + (size_t)kb * N + n;
        const int8_t* base = w_vals + (size_t)kb * nnz_w * N + n;
        uint32_t masks = 0u, vals[8];
        if (vec) {
          masks = *(const uint32_t*)mrow;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            vals[j] = j < nnz_w ? *(const uint32_t*)(base + (size_t)j * N) : 0u;
        } else {
          const int nc = min(4, N - n);
          for (int c = 0; c < nc; ++c) masks |= (uint32_t)mrow[c] << (8 * c);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            vals[j] = 0u;
            if (j < nnz_w)
              for (int c = 0; c < nc; ++c)
                vals[j] |= (uint32_t)(uint8_t)base[(size_t)j * N + c] << (8 * c);
          }
        }
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

// The epilogue of a generic split-K launch, one thread per output.
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
  dbb_int8_generic_kernel<TM, PACKED_A, SPLIT, OutT, ACT><<<grid, THREADS, 0, st>>>(
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

// ---------------------------------------------------------------------------
// The tc body: a cp.async ring of raw packed tiles, a table decode straight
// into mma fragments, split-K summed in a thread-block cluster.

constexpr int TC_THREADS = 256;  // 8 warps
constexpr int TC_STAGES = 4;     // k-steps of the ring: one in use, three in flight
constexpr int TC_KBT = 16;       // 8-blocks per k-step (128 k: four m16n8k32 slices)
constexpr int TC_MAX_SPLIT = 8;  // blocks of a cluster (the portable size)
constexpr int TC_BN = 128;       // output columns per block: 4 strips of 32
constexpr int TC_CH = TC_BN / 16;  // 16-byte chunks of a weight row in a stage
constexpr int TC_XROW = 8 * TC_KBT + 16;  // #2's x rows in a stage: 128 bytes + 16 of pad

__host__ __device__ inline int align128i(int v) { return (v + 127) & ~127; }

// Byte offsets of the tc body's dynamic shared memory: the two decode
// tables (1 KB each), then the ring.  A stage holds one k-step as it lies
// in device memory: w_vals [16][NNZw][BN], w_mask [16][BN] (16-byte chunks
// swizzled), and x_vals [BM][16 * NNZa] with x_mask [BM][16] (#3) or x_q
// [BM][TC_XROW] (#2), and 16 bytes of slack (the unaligned x_vals reads of
// NNZa < 4 read one word past a row).  After the loop the ring holds the
// block's int32 partial tile [BM][BN + 4].
struct TcSmem {
  int lut_w, lut_a, ring, wv, wm, xv, xm, stage, part_row, total;
};

__host__ __device__ inline TcSmem tc_smem(int BM, int nnz_w, int nnz_a, bool packed) {
  TcSmem L;
  L.lut_w = 0;
  L.lut_a = 1024;
  L.ring = 2048;
  L.wv = 0;
  L.wm = L.wv + TC_KBT * nnz_w * TC_BN;
  L.xv = L.wm + TC_KBT * TC_BN;
  L.xm = L.xv + (packed ? BM * TC_KBT * nnz_a : BM * TC_XROW);
  L.stage = align128i(L.xm + (packed ? BM * TC_KBT : 0) + 16);
  L.part_row = TC_BN + 4;
  const int ring = TC_STAGES * L.stage, part = BM * L.part_row * 4;
  L.total = L.ring + (ring > part ? ring : part);
  return L;
}

// The chunk swizzle of a weight row in a stage: rows of 8-block b have
// their eight 16-byte chunks XORed by 2 * (b / 4).
__device__ __forceinline__ int wswz(int b) { return 2 * (b >> 2); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes, or 16 zero bytes when !full (the src is then not
// read; a valid address is passed all the same)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NW consecutive 32-bit words from shared memory, NW * 4-byte aligned
template <int NW>
__device__ __forceinline__ void lds_words(const unsigned char* p, uint32_t (&w)[NW]) {
  if constexpr (NW >= 4) {
#pragma unroll
    for (int i = 0; i < NW; i += 4) {
      const uint4 u = *(const uint4*)(p + 4 * i);
      w[i] = u.x;
      w[i + 1] = u.y;
      w[i + 2] = u.z;
      w[i + 3] = u.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 u = *(const uint2*)p;
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = *(const uint32_t*)p;
  }
}

// NB consecutive bytes (1, 2 or 4, NB-aligned) from shared memory, as the
// low bytes of a word
template <int NB>
__device__ __forceinline__ uint32_t lds_bytes(const unsigned char* p) {
  if constexpr (NB == 4) return *(const uint32_t*)p;
  else if constexpr (NB == 2) return *(const uint16_t*)p;
  else return *p;
}

// The warp layout of a tc instance: 8 warps = WM (m-tile groups) x 4
// (32-column strips) x WK (slices of a k-step).
template <int TM>
struct TcShape {
  static constexpr int BM = 16 * TM;
  static constexpr int WM = TM == 4 ? 2 : 1;
  static constexpr int WN = TC_BN / 32;
  static constexpr int WK = 8 / (WM * WN);
  static constexpr int TMW = TM / WM;  // m-tiles of a warp
  static constexpr int QW = 4 / WK;    // 32-deep slices of a k-step a warp takes
  static_assert(WM * WN * WK == 8 && 4 % WK == 0, "8 warps");
};

// out[m, n .. n + 4) from four exact accumulators: the oracle's epilogue
__device__ __forceinline__ void finish4(const int (&acc)[4], int m, int n, int N,
                                        const float* __restrict__ x_scale, int per_row,
                                        const float* __restrict__ w_scale,
                                        const float* __restrict__ bias, int act, int out_bf16,
                                        void* __restrict__ out, int32_t* __restrict__ acc_out) {
  const size_t o = (size_t)m * N + n;
  const float xs = x_scale[per_row ? m : 0];
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (acc_out != nullptr) acc_out[o + i] = acc[i];
    y[i] = __fmul_rn(__int2float_rn(acc[i]), __fmul_rn(xs, w_scale[n + i]));
    if (bias != nullptr) y[i] = __fadd_rn(y[i], bias[n + i]);
    y[i] = activate_rt(act, y[i]);
  }
  if (out_bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    uint2 u;
    memcpy(&u.x, &lo, 4);
    memcpy(&u.y, &hi, 4);
    *(uint2*)((__nv_bfloat16*)out + o) = u;
  } else {
    *(float4*)((float*)out + o) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

// One (8-block, 4 adjacent columns) of the weights, decoded from the raw
// stage into the B fragments (b0 = low word, b1 = high word) of the
// thread's 4 n-tiles.  v: the block's row of slot 0 at the thread's
// columns (slots NNZw * ... apart: `slot` bytes), mk: its mask row.
__device__ __forceinline__ void decode_w4(const unsigned char* v, int slot, int nnz_w,
                                          uint32_t masks, const uint32_t* __restrict__ lut,
                                          uint32_t (&bf)[4][2]) {
  uint32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = j < nnz_w ? *(const uint32_t*)(v + j * slot) : 0u;
  // transpose 4 slots x 4 columns into one word of slots a column
  const uint32_t t01l = __byte_perm(s[0], s[1], 0x5140), t01h = __byte_perm(s[0], s[1], 0x7362);
  const uint32_t t23l = __byte_perm(s[2], s[3], 0x5140), t23h = __byte_perm(s[2], s[3], 0x7362);
  const uint32_t col[4] = {__byte_perm(t01l, t23l, 0x5410), __byte_perm(t01l, t23l, 0x7632),
                           __byte_perm(t01h, t23h, 0x5410), __byte_perm(t01h, t23h, 0x7632)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t e = lut[(masks >> (8 * j)) & 0xFFu];
    bf[j][0] = __byte_perm(col[j], 0u, e);
    bf[j][1] = __byte_perm(col[j], 0u, e >> 16);
  }
}

// Grid (n_split, N tiles, M tiles); one cluster of n_split blocks along x
// per output tile: block x sums the 8-blocks [x * kb_per_split, ...).
template <int TM, bool PACKED_A>
__global__ void __launch_bounds__(TC_THREADS, TM == 4 ? 2 : 3)
dbb_int8_tc_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ x_mask,
                   const float* __restrict__ x_scale, int per_row,
                   const int8_t* __restrict__ w_vals, const uint8_t* __restrict__ w_mask,
                   const float* __restrict__ w_scale, const float* __restrict__ bias,
                   void* __restrict__ out, int32_t* __restrict__ acc_out,
                   const uint32_t* __restrict__ lut, int M, int N, int KB, int nnz_a, int nnz_w,
                   int kb_per_split, int act, int out_bf16) {
  using S = TcShape<TM>;
  constexpr int BM = S::BM, CH = TC_CH, NT = TC_THREADS;
  constexpr int TMW = S::TMW, QW = S::QW, WN = S::WN, WK = S::WK;
  constexpr int WCH = (TC_KBT * 4 * CH + NT - 1) / NT;  // w_vals chunks a thread, at most
  constexpr int XCPR = PACKED_A ? 4 : TC_XROW / 16 - 1;  // x chunks of a row, at most
  constexpr int XCH = (BM * XCPR + NT - 1) / NT;          // x chunks a thread, at most
  constexpr int AW = PACKED_A ? QW : 2 * QW;              // x words of a row a step
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem L = tc_smem(BM, nnz_w, nnz_a, PACKED_A);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * TC_BN, m0 = blockIdx.z * BM;
  const int kb_begin = blockIdx.x * kb_per_split;
  const int nsteps = (min(KB, kb_begin + kb_per_split) - kb_begin) / TC_KBT;
  unsigned char* ring = smem + L.ring;

  // the decode tables: 64 16-byte chunks each, with the first step
  if (tid < 64) {
    cp_async16z(smem + L.lut_w + 16 * tid, lut + (nnz_w - 1) * 256 + 4 * tid, true);
  } else if (PACKED_A && tid < 128) {
    cp_async16z(smem + L.lut_a + 16 * (tid - 64), lut + (nnz_a - 1) * 256 + 4 * (tid - 64), true);
  }

  // Each thread's chunks of a stage, worked out once (no division per
  // copy): the stage offset and the source offset from the step's base.
  const int wrows = TC_KBT * nnz_w;
  int w_so[WCH], w_go[WCH];
  unsigned w_ok = 0;
#pragma unroll
  for (int i = 0; i < WCH; ++i) {
    const int c = tid + i * NT, r = c / CH, cc = c % CH;
    w_so[i] = r < wrows ? L.wv + r * TC_BN + (cc ^ wswz(r / nnz_w)) * 16 : -1;
    w_go[i] = r * N + n0 + cc * 16;
    if (r < wrows && n0 + cc * 16 < N) w_ok |= 1u << i;
  }
  const int mk_r = tid / CH, mk_c = tid % CH;
  const bool mk_has = tid < TC_KBT * CH, mk_ok = mk_has && n0 + mk_c * 16 < N;
  const int mk_so = L.wm + mk_r * TC_BN + (mk_c ^ wswz(mk_r)) * 16;
  const int mk_go = mk_r * N + n0 + mk_c * 16;
  const int xcpr = PACKED_A ? nnz_a : TC_XROW / 16 - 1;  // 16-byte chunks of an x row's step
  const int xrow = PACKED_A ? TC_KBT * nnz_a : TC_XROW;   // bytes of an x row in a stage
  const long long xld = PACKED_A ? (long long)KB * nnz_a : (long long)KB * 8;  // x row stride
  int x_so[XCH];
  long long x_go[XCH];
  unsigned x_ok = 0;
#pragma unroll
  for (int i = 0; i < XCH; ++i) {
    const int c = tid + i * NT, r = c / xcpr, cc = c % xcpr;
    x_so[i] = r < BM ? L.xv + r * xrow + cc * 16 : -1;
    x_go[i] = (long long)(m0 + r) * xld + cc * 16;
    if (r < BM && m0 + r < M) x_ok |= 1u << i;
  }
  const bool xm_has = PACKED_A && tid < BM, xm_ok = xm_has && m0 + tid < M;

  auto issue = [&](int step) {  // k-step `step` of this split into its stage
    if (step < nsteps) {
      unsigned char* st = ring + (step % TC_STAGES) * L.stage;
      const int kb0 = kb_begin + step * TC_KBT;
      const int8_t* wb = w_vals + (size_t)kb0 * nnz_w * N;
#pragma unroll
      for (int i = 0; i < WCH; ++i)
        if (w_so[i] >= 0)
          cp_async16z(st + w_so[i], (w_ok >> i & 1u) ? wb + w_go[i] : w_vals, w_ok >> i & 1u);
      if (mk_has)
        cp_async16z(st + mk_so, mk_ok ? w_mask + (size_t)kb0 * N + mk_go : w_mask, mk_ok);
      const int8_t* xb = x + (size_t)kb0 * (PACKED_A ? nnz_a : 8);
#pragma unroll
      for (int i = 0; i < XCH; ++i)
        if (x_so[i] >= 0)
          cp_async16z(st + x_so[i], (x_ok >> i & 1u) ? xb + x_go[i] : x, x_ok >> i & 1u);
      if (xm_has)
        cp_async16z(st + L.xm + tid * TC_KBT,
                    xm_ok ? x_mask + (long long)(m0 + tid) * KB + kb0 : x_mask, xm_ok);
    }
    cp_commit();
  };

  // this warp's place: m-tiles wm * TMW .., columns wn * 32 .. + 32, slices
  // wk * QW .. of each step; lane (g, t) takes 8-blocks 4t + wk * QW + qq
  const int wk = warp % WK, wn = (warp / WK) % WN, wm = warp / (WK * WN);
  const int g = lane >> 2, t = lane & 3;
  const int b0 = 4 * t + wk * QW;
  // the thread's 4 columns in a weight row of 8-block quad t (swizzled)
  const int bcol = ((2 * wn + (g >> 2)) ^ wswz(b0)) * 16 + (g & 3) * 4;
  bool tile_on[TMW], hi_on[TMW];
#pragma unroll
  for (int i = 0; i < TMW; ++i) {
    const int r0 = m0 + (wm * TMW + i) * 16;
    tile_on[i] = r0 < M;
    hi_on[i] = r0 + 8 < M;
  }

  int acc[TMW][4][4];
#pragma unroll
  for (int i = 0; i < TMW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) issue(s);

  const uint32_t* lut_w = (const uint32_t*)(smem + L.lut_w);
  const uint32_t* lut_a = (const uint32_t*)(smem + L.lut_a);
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<TC_STAGES - 2>();  // step s landed (this thread's copies) ...
    __syncthreads();           // ... everyone's; step s - 1's stage fully read
    issue(s + TC_STAGES - 1);
    const unsigned char* st = ring + (s % TC_STAGES) * L.stage;
    // the step's raw activations of this thread's rows (g, g + 8 of each
    // m-tile): #3 QW value words and QW mask bytes, #2 2 * QW words
    uint32_t av[TMW][2][AW], am[TMW][2];
#pragma unroll
    for (int i = 0; i < TMW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        am[i][h] = 0u;
#pragma unroll
        for (int q = 0; q < AW; ++q) av[i][h][q] = 0u;
        if (!(h ? hi_on[i] : tile_on[i])) continue;
        const int r = (wm * TMW + i) * 16 + g + 8 * h;
        const unsigned char* row = st + L.xv + r * xrow;
        if constexpr (PACKED_A) {
          am[i][h] = lds_bytes<QW>(st + L.xm + r * TC_KBT + b0);
          if (nnz_a == 4) {
            lds_words<QW>(row + 4 * b0, av[i][h]);
          } else {  // the block's nnz_a bytes from an unaligned offset
#pragma unroll
            for (int q = 0; q < QW; ++q) {
              const int byte = nnz_a * (b0 + q);
              const uint32_t* w32 = (const uint32_t*)(row + (byte & ~3));
              av[i][h][q] = __funnelshift_r(w32[0], w32[1], 8 * (byte & 3));
            }
          }
        } else {
          lds_words<AW>(row + 8 * b0, av[i][h]);
        }
      }
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      const int b = b0 + q;
      uint32_t bf[4][2];
      decode_w4(st + L.wv + b * nnz_w * TC_BN + bcol, TC_BN, nnz_w,
                *(const uint32_t*)(st + L.wm + b * TC_BN + bcol), lut_w, bf);
#pragma unroll
      for (int i = 0; i < TMW; ++i) {
        if (!tile_on[i]) continue;
        uint32_t lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (PACKED_A) {
            const uint32_t e = lut_a[(am[i][h] >> (8 * q)) & 0xFFu];
            lo[h] = __byte_perm(av[i][h][q], 0u, e);
            hi[h] = __byte_perm(av[i][h][q], 0u, e >> 16);
          } else {
            lo[h] = av[i][h][2 * q];
            hi[h] = av[i][h][2 * q + 1];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], lo[0], lo[1], hi[0], hi[1], bf[j][0], bf[j][1]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring's last reads are done before it holds the partial tile

  // The block's partial tile [BM][BN + 4] in the ring: a thread holds
  // columns wn * 32 + 8t .. + 8 of rows g, g + 8 of each m-tile (c0 of
  // n-tile j is column 8t + j, c1 column 8t + 4 + j); the WK warps of a
  // strip add theirs in turn.
  int32_t* part = (int32_t*)ring;
  const int PR = L.part_row;
#pragma unroll
  for (int k = 0; k < WK; ++k) {
    if (wk == k) {
#pragma unroll
      for (int i = 0; i < TMW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int4* p = (int4*)(part + ((wm * TMW + i) * 16 + g + 8 * h) * PR + wn * 32 + 8 * t);
          int4 lo = make_int4(acc[i][0][2 * h], acc[i][1][2 * h], acc[i][2][2 * h], acc[i][3][2 * h]);
          int4 hi = make_int4(acc[i][0][2 * h + 1], acc[i][1][2 * h + 1], acc[i][2][2 * h + 1],
                              acc[i][3][2 * h + 1]);
          if (k > 0) {
            const int4 a = p[0], b = p[1];
            lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
            hi.x += b.x; hi.y += b.y; hi.z += b.z; hi.w += b.w;
          }
          p[0] = lo;
          p[1] = hi;
        }
    }
    __syncthreads();
  }

  // Each block of the cluster sums its share of the tile's 4-column groups
  // over the cluster's partials (integer: any order) and finishes them.
  const int n_split = gridDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  if (n_split > 1) cluster.sync();
  const int rank = n_split > 1 ? (int)cluster.block_rank() : 0;
  const int rows = min(BM, M - m0), q4 = min(TC_BN, N - n0) / 4;
  const int total = rows * q4, per = (total + n_split - 1) / n_split;
  const int q_end = min(total, (rank + 1) * per);
  for (int q = rank * per + tid; q < q_end; q += NT) {
    const int r = q / q4, c = (q % q4) * 4;
    const int off = r * PR + c;
    int4 sum = *(const int4*)(part + off);
    for (int j = 1; j < n_split; ++j) {
      const int4 v = *(const int4*)(cluster.map_shared_rank(part, (j + rank) % n_split) + off);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int a4[4] = {sum.x, sum.y, sum.z, sum.w};
    finish4(a4, m0 + r, n0 + c, N, x_scale, per_row, w_scale, bias, act, out_bf16, out, acc_out);
  }
  if (n_split > 1) cluster.sync();  // no block leaves while another still reads its partial
}

template <int TM, bool PACKED_A>
cudaError_t launch_tc(const void* x, const uint8_t* xm, const float* xsc, int per_row,
                      const int8_t* wv, const uint8_t* wm, const float* wsc, const float* bias,
                      void* out, int32_t* acc_out, const uint32_t* lut, int M, int N, int KB,
                      int nnz_a, int nnz_w, int kb_per_split, int n_split, int act, int out_bf16,
                      cudaStream_t st) {
  auto kernel = dbb_int8_tc_kernel<TM, PACKED_A>;
  static bool attr_set = false;  // once per instance: the most any NNZ <= 4 needs
  if (!attr_set) {
    const int most = tc_smem(16 * TM, 4, 4, PACKED_A).total;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, (N + TC_BN - 1) / TC_BN, (M + 16 * TM - 1) / (16 * TM));
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = tc_smem(16 * TM, nnz_w, nnz_a, PACKED_A).total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const int8_t*)x, xm, xsc, per_row, wv, wm,
                                       wsc, bias, out, acc_out, lut, M, N, KB, nnz_a, nnz_w,
                                       kb_per_split, act, out_bf16);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Output tiles a generic launch has for (M, N): the wrapper picks its
// split_k from it.
extern "C" int dbb_matmul_int8_tiles(int M, int N) {
  return ((N + BN - 1) / BN) * (M <= 16 ? (M + 15) / 16 : (M + 63) / 64);
}

// C entry point, bound with ctypes (kernels/dbb_matmul.py).  Every pointer
// and the stream are void*; sizes are int.  packed_a selects kernel #3
// (x = x_vals [M, KB, nnz_a], x_mask [M, KB] given) over kernel #2 (x =
// dense x_q [M, KB * 8], x_mask NULL).  bias and acc_out may be NULL.
// body 1 runs the tc body: bm 16 or 64 rows a block, split_k (<= 8) K
// splits of kb_per_split 8-blocks (a multiple of 16, none empty), KB % 16
// == 0, N % 16 == 0, nnz_a, nnz_w <= 4, x, x_mask, w_vals and w_mask
// 16-byte aligned, lut the [4][256] decode tables (one per NNZ), no scratch.
// body 0 runs the generic body at any N (4 columns a load where N % 4 == 0
// and w_vals and w_mask are 4-byte aligned, byte loads with a guarded
// column tail otherwise); split_k > 1 needs acc_ws, int32 [M, N] scratch
// (bm, kb_per_split and lut unread).  Returns cudaGetLastError() after the
// launches; cudaErrorInvalidValue for arguments the chosen body does not take.
extern "C" int dbb_matmul_int8(const void* x, const void* x_mask, const void* x_scale,
                               int x_scale_per_row, const void* w_vals, const void* w_mask,
                               const void* w_scale, const void* bias, void* out,
                               void* acc_out, void* acc_ws, int M, int N, int KB, int nnz_a,
                               int nnz_w, int split_k, int packed_a, int out_bf16, int act,
                               int body, int bm, int kb_per_split, const void* lut,
                               void* stream) {
  if (M <= 0 || N <= 0 || KB <= 0 || nnz_w < 1 || nnz_w > 8 ||
      (packed_a && (nnz_a < 1 || nnz_a > 8)) || split_k < 1 || act < ACT_NONE ||
      act > ACT_GELU)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)w_vals % 16 == 0 &&
                         (uintptr_t)w_mask % 16 == 0 &&
                         (!packed_a || (uintptr_t)x_mask % 16 == 0);
    if (N % 16 || KB % TC_KBT || kb_per_split < TC_KBT || kb_per_split % TC_KBT ||
        split_k > TC_MAX_SPLIT || (long long)kb_per_split * split_k < KB ||
        (long long)kb_per_split * (split_k - 1) >= KB || nnz_w > 4 ||
        (packed_a && nnz_a > 4) || (bm != 16 && bm != 64) ||
        lut == nullptr || !aligned)
      return (int)cudaErrorInvalidValue;
    const auto launch = bm == 16 ? (packed_a ? launch_tc<1, true> : launch_tc<1, false>)
                                 : (packed_a ? launch_tc<4, true> : launch_tc<4, false>);
    return (int)launch(x, (const uint8_t*)x_mask, (const float*)x_scale, x_scale_per_row,
                       (const int8_t*)w_vals, (const uint8_t*)w_mask, (const float*)w_scale,
                       (const float*)bias, out, (int32_t*)acc_out, (const uint32_t*)lut, M, N,
                       KB, packed_a ? nnz_a : 1, nnz_w, kb_per_split, split_k, act, out_bf16, s);
  }
  if (body != 0 || (split_k > 1 && acc_ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int8_t*)x, (const uint8_t*)x_mask, (const float*)x_scale,
               x_scale_per_row, (const int8_t*)w_vals, (const uint8_t*)w_mask,
               (const float*)w_scale, (const float*)bias, out, (int32_t*)acc_out,
               (int32_t*)acc_ws, M, N, KB, nnz_a, nnz_w, split_k};
  cudaError_t err;
  if (packed_a) {
    err = out_bf16 ? launch_tm<true, __nv_bfloat16>(act, a, s) : launch_tm<true, float>(act, a, s);
  } else {
    err = out_bf16 ? launch_tm<false, __nv_bfloat16>(act, a, s) : launch_tm<false, float>(act, a, s);
  }
  return (int)err;
}
