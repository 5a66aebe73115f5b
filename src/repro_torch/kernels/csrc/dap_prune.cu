// Dynamic activation pruning (DAP) for Hopper (sm_90a): one selection body,
// four output forms, one launch per call.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/dap_prune.py::dap_prune_pallas  (_dap_kernel)
// and the reference's plain producers of the packed wire formats,
//   repro/kernels/ops.py::dap_pack       (dbb.pack_bitmask)
//   repro/kernels/ops.py::dap_pack_int8  (dbb.pack_bitmask_int8, per row)
// which XLA fuses into one pass on the TPU and eager PyTorch would run as
// some fifty launches.  The forms, each bit for bit its plain version in
// kernels/ref.py:
//   dense       pruned x [M, K] in x's dtype + mask [M, K/8]  dap_prune_ref
//   pack        vals [M, K/8, NNZ] in x's dtype + mask         dap_pack_ref
//   dense_int8  int8 pruned x [M, K] + f32 scale a row         dap_prune_int8_ref
//   pack_int8   int8 vals [M, K/8, NNZ] + mask + scale a row   dap_pack_int8_ref
//
// Selection.  Within every block of 8 consecutive elements of a row, NNZ
// stages of a magnitude max cascade (the paper's Fig. 8) each keep the
// largest magnitude not yet kept, ties going to the lower position
// (NNZ = 8 keeps everything).  Below that, a block that holds a NaN keeps
// nothing: the plain version's max propagates NaN, so no position ever
// equals the stage's maximum.  (CUDA's fmaxf would drop the NaN, so the
// cascade compares magnitudes as integers: with the sign bit cleared,
// non-negative floats order exactly as their bits do, and a NaN is a
// magnitude above the infinity pattern.)  The dense form keeps a selected
// -0.0 as -0.0; its mask bit b marks a non-zero kept at position b.  The
// packed forms keep no zero of either sign: slot j holds the value of the
// j-th set mask bit in ascending position, unused slots +0.0 (int8 0).
//
// The int8 forms quantize what was kept with one scale a row (as the
// reference's dap_pack_int8(act_scale="per_row") and its int8 wire's
// per-row activation quantization, repro/kernels/ref.py::quantize_act_int8):
// amax = max |v| over the kept values (NaN if one is NaN), scale = amax /
// 127 if amax > 0 else 1, q = clamp(rint(v / scale), -127, 127), both
// divisions IEEE-rounded (__fdiv_rn, as ATen divides a tensor by a
// tensor); a NaN quotient (a kept infinity over an infinite scale) casts
// to 0, as the card's float-to-int8 conversion does.
//
// What bounds it on the H100.  Each element is read once, and a call
// writes at most as many bytes: a pure streaming pass bound by the bytes
// (3.35 TB/s).  At the main path's shapes (M = 4 to 64 rows of 768 to
// 12800 features) a call moves at most a few MB, so what a call costs is
// its launch: the design spends exactly one per call site, with no memset,
// no second pass and no host work beyond allocating the outputs.
//
// What the design does about it.
// * dense, pack: one thread per 8-block over the whole tensor.
//   Consecutive threads take consecutive blocks, so a warp's loads are
//   whole, coalesced 16-byte vectors (one a thread for bf16, two for f32)
//   and its mask bytes one 32-byte segment; a block's NNZ = 4 slots go out
//   as one 8-byte (bf16) or 16-byte (f32) store.
// * dense_int8, pack_int8: a cluster of 1 to 8 blocks a row, as many as
//   the SMs hold for the call's rows (the launch plan,
//   kernels/dap_prune.py::row_plan: 8 at a decode step's 4 rows, 2 at a
//   mixed step's 64; measured faster than one block a row, 1.33 against
//   1.49 ms and 1.53 against 1.55 ms a granite pass, scripts/bench_dap.py
//   on an H100).  Each thread loads up to PER 8-blocks of the row into
//   registers, selects, and keeps them there across the row's amax: a
//   warp max (redux.sync), one shared-memory step, and in a cluster one
//   exchange of the blocks' partial maxima through distributed shared
//   memory.  x is read from device memory once.  Only a block's kept
//   non-zeros divide (NNZ slots, not 8 positions).  The amax is an integer
//   max of magnitude bit patterns, so it is exact in any order and a row's
//   bits never depend on M, on the plan or on the other rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;      // block-local forms: threads a block
constexpr int ROW_MAX_THREADS = 512;  // row forms: the most a block takes
constexpr int MAX_CLUSTER = 8;    // row forms: blocks a row at most (portable)

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_word(uint4& v, int i, uint32_t w) {
  if (i == 0) v.x = w;
  else if (i == 1) v.y = w;
  else if (i == 2) v.z = w;
  else v.w = w;
}

// One 8-block as loaded: V = EB / 2 16-byte vectors.
template <int EB>
struct Block8 {
  uint4 v[EB / 2];
};

// The raw element patterns of an 8-block (bf16: 16 bits, zero-extended).
template <int EB>
__device__ __forceinline__ void unpack(const Block8<EB>& b, uint32_t raw[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (EB == 2) {
      raw[i] = (word(b.v[0], i >> 1) >> ((i & 1) * 16)) & 0xFFFFu;  // little-endian pairs
    } else {
      raw[i] = word(b.v[i / 4], i % 4);
    }
  }
}

// The cascade: bit i of the result marks position i kept (dense semantics:
// zeros may be kept).  mag holds the magnitudes' bit patterns.
template <int EB>
__device__ __forceinline__ uint32_t select_kept(const uint32_t raw[8], uint32_t mag[8], int nnz) {
  constexpr uint32_t ABS = EB == 2 ? 0x7FFFu : 0x7FFFFFFFu;
  constexpr uint32_t INF = EB == 2 ? 0x7F80u : 0x7F800000u;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mag[i] = raw[i] & ABS;
    nan |= mag[i] > INF;
  }
  if (nnz == 8) return 0xFFu;  // dense bypass: x unchanged, NaNs included
  if (nan) return 0u;
  uint32_t kept = 0;
  for (int s = 0; s < nnz; ++s) {
    int best = -1;
    uint32_t top = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // strict >: the first (lowest) position of the maximum wins
      if (!((kept >> i) & 1u) && (best < 0 || mag[i] > top)) {
        best = i;
        top = mag[i];
      }
    }
    kept |= 1u << best;
  }
  return kept;
}

// The mask bits: kept and non-zero (a kept -0.0 takes no bit).
__device__ __forceinline__ uint32_t nonzero_bits(uint32_t kept, const uint32_t mag[8]) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) bits |= (uint32_t)(((kept >> i) & 1u) && mag[i] != 0u) << i;
  return bits;
}

// Rank-order compaction in registers: s[j] = raw of the j-th set bit, 0
// past the last (a select network: no register is indexed at run time).
__device__ __forceinline__ void compact(const uint32_t raw[8], uint32_t bits, uint32_t s[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0u;
  int r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool b = (bits >> i) & 1u;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (b && r == j) s[j] = raw[i];
    }
    r += b;
  }
}

// Slots 0..nnz-1 of one 8-block to base (EB bytes each, the block's first
// slot at base; EB = 1: int8 codes): NNZ = 4, the served density, as one
// 16-byte (f32), 8-byte (bf16) or 4-byte (int8) store.
template <int EB>
__device__ __forceinline__ void store_slots(void* base, int nnz, const uint32_t s[8]) {
  if (nnz == 4) {
    if constexpr (EB == 4) *(uint4*)base = make_uint4(s[0], s[1], s[2], s[3]);
    else if constexpr (EB == 2) *(uint2*)base = make_uint2(s[0] | (s[1] << 16), s[2] | (s[3] << 16));
    else *(uint32_t*)base = s[0] | (s[1] << 8) | (s[2] << 16) | (s[3] << 24);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nnz) {
      if constexpr (EB == 4) ((uint32_t*)base)[j] = s[j];
      else if constexpr (EB == 2) ((uint16_t*)base)[j] = (uint16_t)s[j];
      else ((uint8_t*)base)[j] = (uint8_t)s[j];
    }
  }
}

// An element pattern as f32 (bf16: the high half of an f32).
template <int EB>
__device__ __forceinline__ float as_float(uint32_t raw) {
  return __uint_as_float(EB == 2 ? raw << 16 : raw);
}

// clamp(rint(v / scale), -127, 127) as an int8 byte; the clamp keeps a NaN
// (as torch.clamp does), which casts to 0.
__device__ __forceinline__ uint32_t quant(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = r < -127.f ? -127.f : (r > 127.f ? 127.f : r);
  return r != r ? 0u : (uint32_t)(uint8_t)(int8_t)(int)r;
}

// dense (PACK false) and pack (PACK true): one thread per 8-block.  x holds
// n_blocks 8-blocks, 16-byte aligned; out the pruned tensor (dense) or the
// NNZ slots of every block (pack); mask one byte per block.
template <int EB, bool PACK>
__global__ void __launch_bounds__(THREADS)
dap_block_kernel(const Block8<EB>* __restrict__ x, void* __restrict__ out,
                 uint8_t* __restrict__ mask, long long n_blocks, int nnz) {
  const long long blk = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (blk >= n_blocks) return;
  const Block8<EB> in = x[blk];
  uint32_t raw[8], mag[8];
  unpack<EB>(in, raw);
  const uint32_t kept = select_kept<EB>(raw, mag, nnz);
  const uint32_t bits = nonzero_bits(kept, mag);
  if constexpr (PACK) {
    uint32_t s[8];
    compact(raw, bits, s);
    store_slots<EB>((char*)out + blk * nnz * EB, nnz, s);
  } else {
    Block8<EB> o;
#pragma unroll
    for (int w = 0; w < 2 * EB; ++w) {
      const uint32_t k0 = (kept >> (EB == 2 ? 2 * w : w)) & 1u;
      if constexpr (EB == 2) {
        const uint32_t k1 = (kept >> (2 * w + 1)) & 1u;
        set_word(o.v[0], w, (k0 ? raw[2 * w] : 0u) | ((k1 ? raw[2 * w + 1] : 0u) << 16));
      } else {
        set_word(o.v[w / 4], w % 4, k0 ? raw[w] : 0u);
      }
    }
    ((Block8<EB>*)out)[blk] = o;
  }
  mask[blk] = (uint8_t)bits;
}

// dense_int8 (PACK false) and pack_int8 (PACK true): a cluster of csize
// blocks a row (blockIdx.x = row * csize + rank), block `rank` taking the
// row's 8-blocks [rank * per_block, (rank + 1) * per_block), each of its
// threads up to PER of them (blockDim.x apart).  q: the int8 pruned row
// (8 bytes a block) or its NNZ codes a block; mask (pack_int8 only): one
// byte a block; scale: one f32 a row.
template <int EB, bool PACK, int PER>
__global__ void __launch_bounds__(ROW_MAX_THREADS)
dap_row_kernel(const Block8<EB>* __restrict__ x, uint8_t* __restrict__ q,
               uint8_t* __restrict__ mask, float* __restrict__ scale, int nb, int nnz,
               int csize, int per_block) {
  __shared__ uint32_t warp_max[ROW_MAX_THREADS / 32];
  __shared__ uint32_t block_max;
  const int row = blockIdx.x / csize;
  const int rank = blockIdx.x % csize;
  const int j0 = rank * per_block;
  const int j1 = min(nb, j0 + per_block);
  const long long row0 = (long long)row * nb;

  // load and select every 8-block this thread takes; keep them in registers
  Block8<EB> held[PER];
  uint32_t keep[PER];
  uint32_t amax = 0;  // the largest kept magnitude, as f32 bits
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = j0 + threadIdx.x + p * blockDim.x;
    keep[p] = 0;
    if (j < j1) {
      held[p] = x[row0 + j];
      uint32_t raw[8], mag[8];
      unpack<EB>(held[p], raw);
      const uint32_t kept = select_kept<EB>(raw, mag, nnz);
      const uint32_t bits = nonzero_bits(kept, mag);
      keep[p] = bits;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t m32 = EB == 2 ? mag[i] << 16 : mag[i];
        if ((bits >> i) & 1u) amax = max(amax, m32);
      }
      if constexpr (PACK) mask[row0 + j] = (uint8_t)bits;
    }
  }

  // the row's amax: warps, then the block, then the cluster
  amax = __reduce_max_sync(0xFFFFFFFFu, amax);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0u;
    v = __reduce_max_sync(0xFFFFFFFFu, v);
    if (lane == 0) block_max = v;
  }
  uint32_t row_max;
  if (csize > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partial is in its shared memory
    row_max = 0;
    for (int r = 0; r < csize; ++r) row_max = max(row_max, *cluster.map_shared_rank(&block_max, r));
    cluster.sync();  // no block leaves while another still reads its partial
  } else {
    __syncthreads();
    row_max = block_max;
  }
  const float amax_f = __uint_as_float(row_max);
  const float s = amax_f > 0.f ? __fdiv_rn(amax_f, 127.f) : 1.f;  // NaN: 1
  if (rank == 0 && threadIdx.x == 0) scale[row] = s;

  // quantize what is held, and store it.  Only the nnz slots of kept
  // non-zeros divide (a zero, kept or pruned, is code 0 at any scale):
  // compact, quantize the slots, and for the dense form put each code back
  // at its position.
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = j0 + threadIdx.x + p * blockDim.x;
    if (j < j1) {
      uint32_t raw[8], slot[8], code[8];
      unpack<EB>(held[p], raw);
      compact(raw, keep[p], slot);
#pragma unroll
      for (int i = 0; i < 8; ++i) code[i] = i < nnz ? quant(as_float<EB>(slot[i]), s) : 0u;
      if constexpr (PACK) {
        store_slots<1>(q + (row0 + j) * nnz, nnz, code);
      } else {
        uint32_t lo = 0, hi = 0;
        int r = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool b = (keep[p] >> i) & 1u;
          uint32_t c = 0;
#pragma unroll
          for (int k = 0; k <= i; ++k) {
            if (b && r == k) c = code[k];
          }
          r += b;
          if (i < 4) lo |= c << (8 * i);
          else hi |= c << (8 * (i - 4));
        }
        ((uint2*)q)[row0 + j] = make_uint2(lo, hi);
      }
    }
  }
}

template <int EB, bool PACK>
cudaError_t launch_block(const void* x, void* out, void* mask, long long n_blocks, int nnz,
                         unsigned grid, cudaStream_t st) {
  dap_block_kernel<EB, PACK><<<grid, THREADS, 0, st>>>((const Block8<EB>*)x, out,
                                                       (uint8_t*)mask, n_blocks, nnz);
  return cudaGetLastError();
}

template <int EB, bool PACK>
cudaError_t launch_rows(const void* x, void* q, void* mask, void* scale, int m, int nb, int nnz,
                        int csize, int threads, int per, int per_block, cudaStream_t st) {
  auto kernel = per == 1   ? dap_row_kernel<EB, PACK, 1>
                : per == 2 ? dap_row_kernel<EB, PACK, 2>
                : per == 4 ? dap_row_kernel<EB, PACK, 4>
                : per == 8 ? dap_row_kernel<EB, PACK, 8>
                           : nullptr;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(m * csize), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const Block8<EB>*)x, (uint8_t*)q,
                                       (uint8_t*)mask, (float*)scale, nb, nnz, csize, per_block);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes (kernels/dap_prune.py).  Every pointer
// and the stream are void*; x is 16-byte aligned and contiguous, of
// elem_bytes (2: bf16, 4: f32) elements; 1 <= nnz <= 8.  Each returns
// cudaGetLastError() after its one launch.

// dense (pack = 0): out [n_blocks * 8] in x's dtype; pack (pack = 1): out
// [n_blocks * nnz] in x's dtype.  mask: n_blocks bytes.
extern "C" int dap_prune(const void* x, void* out, void* mask, long long n_blocks, int nnz,
                         int elem_bytes, int pack, void* stream) {
  if (n_blocks < 0 || nnz < 1 || nnz > 8 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const long long grid = (n_blocks + THREADS - 1) / THREADS;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto launch = elem_bytes == 2 ? (pack ? launch_block<2, true> : launch_block<2, false>)
                                : (pack ? launch_block<4, true> : launch_block<4, false>);
  return (int)launch(x, out, mask, n_blocks, nnz, (unsigned)grid, (cudaStream_t)stream);
}

// dense_int8 (pack = 0): q [m, nb * 8] int8, mask unused; pack_int8
// (pack = 1): q [m, nb, nnz] int8, mask [m, nb].  scale: m floats.  The
// plan (kernels/dap_prune.py::row_plan): csize blocks a row (a cluster),
// `threads` a block, each taking up to `per` 8-blocks, per_block 8-blocks
// a block; per_block <= threads * per.
extern "C" int dap_prune_rows(const void* x, void* q, void* mask, void* scale, int m, int nb,
                              int nnz, int elem_bytes, int pack, int csize, int threads,
                              int per, int per_block, void* stream) {
  if (m < 0 || nb < 1 || nnz < 1 || nnz > 8 || (elem_bytes != 2 && elem_bytes != 4) ||
      csize < 1 || csize > MAX_CLUSTER || threads < 32 || threads > ROW_MAX_THREADS ||
      threads % 32 || per_block < 1 || (long long)per_block * csize < nb ||
      per_block > threads * per || (long long)m * csize > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  auto launch = elem_bytes == 2 ? (pack ? launch_rows<2, true> : launch_rows<2, false>)
                                : (pack ? launch_rows<4, true> : launch_rows<4, false>);
  return (int)launch(x, q, mask, scale, m, nb, nnz, csize, threads, per, per_block,
                     (cudaStream_t)stream);
}
