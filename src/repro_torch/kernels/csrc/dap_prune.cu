// Dynamic activation pruning (DAP) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/dap_prune.py::dap_prune_pallas  (_dap_kernel)
// and computes its plain version kernels/ref.py::dap_prune_ref bit for
// bit: within every block of 8 consecutive elements of a row, NNZ stages
// of a magnitude max cascade (the paper's Fig. 8) each keep the largest
// magnitude not yet kept, ties going to the lower position; the output is
// the pruned dense tensor (x where kept, +0.0 elsewhere; a kept -0.0
// stays -0.0) and one uint8 mask per block whose bit b marks a non-zero
// kept at position b (NNZ = 8 passes x through).  Below that, a block
// that holds a NaN keeps nothing: the plain version's max propagates
// NaN, so no position ever equals the stage's maximum.  (CUDA's fmaxf
// would drop the NaN and keep the other values, so the cascade here
// compares magnitudes as integers instead.)
//
// What bounds it on the H100.  Each element is read once and written
// once, plus one mask byte per 8 elements, and the cascade costs about
// 8 * NNZ integer compares per block: a pure streaming pass, bound by the
// bytes (3.35 TB/s).  At the main path's shapes (M = 4 to 64 rows of
// 768 to 4096 features) a call moves well under 1 MB, so in practice a
// launch costs its fixed overhead.
//
// What the design does about it.  One thread per 8-block: consecutive
// threads take consecutive blocks, so a warp's loads and stores are
// whole, coalesced 16-byte vectors (one per thread for bf16, two for
// f32) and its mask bytes one 32-byte segment.  The cascade runs in
// registers on the magnitudes' bit patterns: with the sign bit cleared,
// non-negative floats order exactly as their bits do as unsigned
// integers, so the comparisons are exact for bf16 and f32 alike, and a
// NaN is a magnitude above the infinity pattern.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_word(uint4& v, int i, uint32_t w) {
  if (i == 0) v.x = w;
  else if (i == 1) v.y = w;
  else if (i == 2) v.z = w;
  else v.w = w;
}

// EB: bytes per element (2: bf16, 4: f32).  x and out hold n_blocks
// blocks of 8 elements, 16-byte aligned; mask holds one byte per block.
template <int EB>
__global__ void __launch_bounds__(THREADS)
dap_prune_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                 uint8_t* __restrict__ mask, long long n_blocks, int nnz) {
  constexpr int V = EB / 2;  // 16-byte vectors per block of 8 elements
  constexpr uint32_t ABS = EB == 2 ? 0x7FFFu : 0x7FFFFFFFu;
  constexpr uint32_t INF = EB == 2 ? 0x7F80u : 0x7F800000u;
  const long long blk = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (blk >= n_blocks) return;

  uint4 in[V];
#pragma unroll
  for (int j = 0; j < V; ++j) in[j] = x[blk * V + j];
  uint32_t raw[8], mag[8];
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (EB == 2) {
      raw[i] = (word(in[0], i >> 1) >> ((i & 1) * 16)) & 0xFFFFu;  // little-endian pairs
    } else {
      raw[i] = word(in[i / 4], i % 4);
    }
    mag[i] = raw[i] & ABS;
    nan |= mag[i] > INF;
  }

  uint32_t kept = 0;
  if (nnz == 8) {
    kept = 0xFFu;  // dense bypass: x unchanged, NaNs included
  } else if (!nan) {
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
  }

  uint32_t sel[8];
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool k = (kept >> i) & 1u;
    sel[i] = k ? raw[i] : 0u;
    bits |= (uint32_t)(k && mag[i] != 0u) << i;
  }
  uint4 o[V];
#pragma unroll
  for (int w = 0; w < 4 * V; ++w) {
    if constexpr (EB == 2) {
      set_word(o[0], w, sel[2 * w] | (sel[2 * w + 1] << 16));
    } else {
      set_word(o[w / 4], w % 4, sel[w]);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) out[blk * V + j] = o[j];
  mask[blk] = (uint8_t)bits;
}

}  // namespace

// C entry point, bound with ctypes (kernels/dap_prune.py).  x and out:
// n_blocks * 8 elements of elem_bytes (2: bf16, 4: f32) each, 16-byte
// aligned, contiguous; mask: n_blocks bytes.  1 <= nnz <= 8.  Returns
// cudaGetLastError() after the launch.
extern "C" int dap_prune(const void* x, void* out, void* mask, long long n_blocks, int nnz,
                         int elem_bytes, void* stream) {
  if (n_blocks < 0 || nnz < 1 || nnz > 8 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const long long grid = (n_blocks + THREADS - 1) / THREADS;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2)
    dap_prune_kernel<2><<<(unsigned)grid, THREADS, 0, st>>>(
        (const uint4*)x, (uint4*)out, (uint8_t*)mask, n_blocks, nnz);
  else
    dap_prune_kernel<4><<<(unsigned)grid, THREADS, 0, st>>>(
        (const uint4*)x, (uint4*)out, (uint8_t*)mask, n_blocks, nnz);
  return (int)cudaGetLastError();
}
