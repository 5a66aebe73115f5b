// Fused paged attention for Hopper (sm_90a): GQA mode and MLA's latent mode.
//
// Three kernels.  Every bf16 call (bf16 q and output, int8 or bf16 pages)
// runs on the tensor cores: GQA calls paged_attn_tc_kernel, MLA's latent
// mode paged_attn_latent_tc_kernel.  f32 calls run the scalar
// paged_attn_kernel.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/paged_attn.py::paged_attn_fused  (_paged_attn_kernel)
// and computes its plain version kernels/ref.py::paged_attn_ref: for each
// (request b, KV head h) walk page_tables[b, :], stream each page's slot
// positions and K/V rows, dequantize int8 pages in the load
// (f32(q) * scale, then rounded to the compute dtype), and keep
// FlashAttention-2 statistics (acc, m, l) in f32 with NEG_INF = -1e30.
// Query rows are head-major: row r = s * G + g for query head h * G + g.
// Masking derives only from the slot positions: -1 is invalid (empty,
// null page, scrubbed), causality is k_pos <= q_pos, and an optional
// sliding window bounds the lookback.  Probabilities are cast to the
// value dtype before P @ V; the output divides by max(l, 1e-30).  Logits
// scale by the caller's softmax scale (1/sqrt(Dk) for GQA; MLA passes
// 1/sqrt(qk_nope + qk_rope), not 1/sqrt of its latent width).
//
// Latent mode (MLA's absorbed attention, latent != 0): KV = 1, each page
// row holds the (c_kv || k_rope) latent, queries are (q_abs || q_rope),
// and v is the first Dv features of the same dequantized k row: the v
// pages (MLA's 1-wide dummy) and any v scale are never read, and the k
// tile in shared memory serves both products.
//
// What bounds it on the H100.  GQA at serving shapes (S * G <= 64 rows per
// KV head, head_dim 128) does about 2 * S * G operations per KV byte, far
// below the card's operations-per-byte balance: its bound is the bytes of
// the pages, scales and slot positions (3.35 TB/s).  The latent mode
// shares one latent row among all S * G rows of a request (640 at a
// 16-token chunk of 40 heads), so there the operations bound it (989
// TFLOP/s bf16).  What a block waits on in practice is its page walk:
// each page is a short chain of dependent steps (barrier, dequantization,
// ldmatrix, mma, shuffles, exp), one page after another, so the split
// width sets a kernel's time, against the workspace the combine reads.
//
// The tensor-core kernels.  S = Q K^T and acc += P V are
// mma.sync.m16n8k16 bf16 products with f32 accumulators; q comes once
// into shared memory, K's B fragments by ldmatrix and V's by
// ldmatrix.trans out of bf16 tiles whose rows are padded by 16 bytes
// (conflict-free ldmatrix).  The statistics (m, l) and acc stay in
// registers, row max and row sum by quad shuffles, and the f32 S fragment,
// exponentiated and rounded to bf16, is the A operand of the P V product
// as it stands: the plain version's "probabilities cast to the value
// dtype before P @ V".  Pages come through a two-stage cp.async ring: the
// next page's rows and scales are in flight while the current page is
// dequantized and multiplied; each thread copies, and for int8
// dequantizes, a fixed set of 16-byte row chunks worked out once, so no
// page costs an integer division.  int8 pages land raw and dequantize
// from shared memory into the bf16 tiles exactly as the scalar kernel
// does, round_bf16(f32(q) * scale).  The slot positions of the block's
// whole page split are read first, so only pages with a valid slot enter
// the ring.  Any page size: a page of more than 64 slots is walked as
// ceil(PS / 64) sub-pages of 64 slots (the last one shorter), each its
// own pass of the S fragment and its own stage of the ring; the K tile's
// slots are padded to a multiple of 8 (the S fragment's n-tile) and the V
// tile's to 16 (P V's k-step), pad rows zero (copied as zero-fill); a pad
// slot has position -1 and its logit is a true -inf, so it adds nothing
// to any row, also to a row that has seen no valid key (NEG_INF there
// would give it weight 1).
// Slot-less pages add their summed v to the rows that have seen no valid
// key (m == NEG_INF) after the ring, in the thread's own register
// fragments; for every other row they add exactly nothing, in whatever
// order.  Splits have a fixed width of pages per mode, so a row's bits
// never depend on B, S, q_pos or its co-batch; a call with one split
// writes the output itself, with no workspace and no combine launch, and
// a row that took no page of a split writes only its (m, l) there, which
// the combine reads first (it reads an acc only where l > 0).
//
// GQA (paged_attn_tc_kernel): one block per (request, KV head, page
// split, up to 64 query rows of whole tokens); one warp per 16-row m-tile
// holding all Dv <= 128 columns (a decode step's G rows pad one tile:
// padding rows compute and are never written).  Shapes: Dk % 16 == 0,
// Dv % 8 == 0 and <= 128, PS >= 1, G <= 64.
//
// Latent (paged_attn_latent_tc_kernel): with KV = 1 the S * G rows of a
// request form one row space, and a block takes a tile of LT_MTILES * 16
// of them across token boundaries (each row reads its own token's
// q_pos), so a page is copied and dequantized once per row tile, not once
// per token.  Dv = 256 columns of f32 accumulators are 128 registers a
// thread for one warp; instead LT_WARPS warps serve each m-tile, compute
// the same S fragment (Q K^T over all Dk columns, its chain of dependent
// mma halved by summing even and odd k-steps apart) and own 1 / LT_WARPS
// of Dv's columns each, whose B fragments come by ldmatrix.trans from the
// first Dv columns of the same K tile.  A row's arithmetic is its own
// warps' and quad's whatever the tile, so its bits do not depend on S or
// its position.  A block whose split has no page with a slot and no
// keyless row leaves after writing its rows' (m, l), before it copies q.
// A latent width that is a multiple of 8 but not of 16 (minicpm3's smoke
// latent of 40) is zero-padded to the next multiple of 16 in q's and K's
// shared rows: the extra columns add exactly 0 to Q K^T, and v stays the
// first Dv columns.  Shapes: Dk % 8 == 0, Dv % 8 == 0 and <= min(Dk,
// 256), PS >= 1, any G.
//
// The scalar kernel (f32).  The dense window is never materialized: a
// block loads each page of its share once into shared memory and serves
// up to 64 query rows of one (request, KV head) from it (a third grid
// dimension takes longer chunks, so shared memory stays bounded).  The
// page walk is split across blocks (flash-decoding): block (b*KV + h, j)
// walks pages [j * pages_per_split, (j + 1) * pages_per_split) and writes
// its partial (m, l, acc); a second kernel merges the splits with the
// usual exp(m_j - max m) rescaling, one thread per output, so
// B * KV * P / pages_per_split blocks keep the card busy instead of B * KV.
// Pages whose slots are all -1 (the null page that pads every table,
// scrubbed pages) are skipped after reading their slot positions; for
// every row with a valid key this is exact (such a page rescales by
// alpha = 1 and adds zero).  A row with no valid key anywhere in its
// table (chunk padding and idle rows at q_pos -1) has every logit at
// NEG_INF, so the plain version and the reference give it the uniform
// mean of v over every slot of the table, the null page's included; an
// MoE layer routes such rows, so they must agree.  A block that holds
// such a row takes the slot-less pages too, without any product: every
// logit there is NEG_INF exactly, so a row that has seen a valid key
// (m > NEG_INF) gains nothing (alpha = 1, probabilities 0) and a row that
// has not (m == NEG_INF) gains probability 1 for each slot, l += PS and
// acc += the sum of the page's v rows, in the order the general path
// adds them.  Only v is read, and a run of one such page (the null page
// that pads a table's tail) is read once and weighted by its length.
// It is thread-per-output FMAs out of f32 shared memory, with synchronous
// loads; no served configuration is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 64;  // query rows (tokens x grouped heads) per block, at most
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// round a float to the compute dtype and back (identity for f32)
__device__ __forceinline__ float round_c(float v, float*) { return v; }
__device__ __forceinline__ float round_c(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A slot-less page, read `reps` times in a row: every logit is NEG_INF
// exactly, so only the rows that have seen no valid key (m == NEG_INF)
// change: l += reps * PS and acc += reps * (the page's v rows summed in
// slot order).  Kept out of line, so the general page walk keeps its
// registers.
template <typename KT, typename CT>
__device__ __noinline__ void add_slotless_page(
    const KT* __restrict__ k_pages, const KT* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, int pid, int reps,
    int PS, int Dv, int kvd_k, int kvd_v, int kvh, int latent, int SG,
    const float* __restrict__ m_s, float* __restrict__ l_s, float* __restrict__ acc_s,
    float* __restrict__ vsum_s) {
  const int tid = threadIdx.x;
  CT* ctag = nullptr;
  for (int d = tid; d < Dv; d += THREADS) {
    float sum = 0.0f;
    for (int sl = 0; sl < PS; ++sl) {
      const size_t row = (size_t)pid * PS + sl;
      float v;
      if (latent) {  // v is the k row's prefix
        v = to_f(k_pages[row * kvd_k + d]);
        if (k_scale != nullptr) v = round_c(v * k_scale[row], ctag);
      } else {
        v = to_f(v_pages[row * kvd_v + (size_t)kvh * Dv + d]);
        if (v_scale != nullptr) v = round_c(v * v_scale[row], ctag);
      }
      sum += v;
    }
    vsum_s[d] = reps * sum;
  }
  __syncthreads();
  for (int i = tid; i < SG * Dv; i += THREADS)
    if (m_s[i / Dv] == NEG_INF) acc_s[i] += vsum_s[i % Dv];
  for (int r = tid; r < SG; r += THREADS)
    if (m_s[r] == NEG_INF) l_s[r] += (float)(reps * PS);
}

// KT: page storage type (int8_t with scale planes, or CT); CT: compute
// dtype of q and of the output.
template <typename KT, typename CT>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const CT* __restrict__ q, const KT* __restrict__ k_pages,
                  const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int32_t* __restrict__ pos_tbl,
                  const int32_t* __restrict__ page_tables, const int32_t* __restrict__ q_pos,
                  float* __restrict__ ws, int S, int H, int KV, int Dk, int Dv, int PS,
                  int P, int pages_per_split, int s_blk, int window, int latent,
                  float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV, SGALL = S * G;
  // this block's query tokens [s_lo, s_lo + SG / G); shared layout sized for SGM rows
  const int s_lo = blockIdx.z * s_blk;
  const int SG = (min(S, s_lo + s_blk) - s_lo) * G, SGM = min(S, s_blk) * G;
  const int QST = Dk + 1, KST = Dk + 1;   // +1: conflict-free row strides
  float* q_s = smem;                      // [SGM][QST]
  float* k_s = q_s + SGM * QST;           // [PS][KST]
  float* v_s = k_s + PS * KST;            // [PS][Dv] (latent: none, v = k_s)
  float* p_s = v_s + (latent ? 0 : PS * Dv);  // [SGM][PS] logits, then probs
  float* acc_s = p_s + SGM * PS;          // [SGM][Dv]
  float* m_s = acc_s + SGM * Dv;          // [SGM]
  float* l_s = m_s + SGM;                 // [SGM]
  float* a_s = l_s + SGM;                 // [SGM] alpha of this page
  int32_t* pos_s = (int32_t*)(a_s + SGM); // [PS]
  float* vsum_s = (float*)(pos_s + PS);   // [Dv] v summed over a slot-less page
  const int tid = threadIdx.x;
  CT* ctag = nullptr;

  for (int i = tid; i < SG * Dk; i += THREADS) {
    const int r = i / Dk, d = i % Dk, s = s_lo + r / G, g = r % G;
    q_s[r * QST + d] = to_f(q[(((size_t)b * S + s) * H + kvh * G + g) * Dk + d]);
  }
  for (int i = tid; i < SG * Dv; i += THREADS) acc_s[i] = 0.0f;
  for (int r = tid; r < SG; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }

  // does a query token of this block have no valid key in its whole
  // table?  (q_pos < 0 never has one; else stop at the first valid slot)
  __shared__ int walk_all;
  if (tid == 0) walk_all = 0;
  __syncthreads();
  for (int t = tid; t < SG / G; t += THREADS) {
    const int qp = q_pos[(size_t)b * S + s_lo + t];
    bool live = false;
    for (int p = 0; qp >= 0 && p < P && !live; ++p) {
      const int pid = page_tables[(size_t)b * P + p];
      for (int sl = 0; sl < PS && !live; ++sl) {
        const int kp = pos_tbl[(size_t)pid * PS + sl];
        live = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
      }
    }
    if (!live) walk_all = 1;
  }

  const int kvd_k = KV * Dk, kvd_v = KV * Dv;
  const int p0 = blockIdx.y * pages_per_split;
  const int p1 = min(P, p0 + pages_per_split);
  for (int p = p0; p < p1; ++p) {
    __syncthreads();  // previous page fully consumed
    const int pid = page_tables[(size_t)b * P + p];
    for (int i = tid; i < PS; i += THREADS) pos_s[i] = pos_tbl[(size_t)pid * PS + i];
    __syncthreads();
    bool any_valid = false;
    for (int i = 0; i < PS; ++i) any_valid |= pos_s[i] >= 0;
    if (!any_valid) {  // uniform across the block
      if (!walk_all) continue;
      // a run of this slot-less page is read once, weighted by its length
      int reps = 1;
      while (p + reps < p1 && page_tables[(size_t)b * P + p + reps] == pid) ++reps;
      add_slotless_page<KT, CT>(k_pages, v_pages, k_scale, v_scale, pid, reps, PS, Dv, kvd_k,
                                kvd_v, kvh, latent, SG, m_s, l_s, acc_s, vsum_s);
      p += reps - 1;
      continue;
    }

    for (int i = tid; i < PS * Dk; i += THREADS) {
      const int sl = i / Dk, d = i % Dk;
      const size_t row = (size_t)pid * PS + sl;
      float v = to_f(k_pages[row * kvd_k + (size_t)kvh * Dk + d]);
      if (k_scale != nullptr) v = round_c(v * k_scale[row], ctag);
      k_s[sl * KST + d] = v;
    }
    for (int i = tid; i < (latent ? 0 : PS * Dv); i += THREADS) {
      const int sl = i / Dv, d = i % Dv;
      const size_t row = (size_t)pid * PS + sl;
      float v = to_f(v_pages[row * kvd_v + (size_t)kvh * Dv + d]);
      if (v_scale != nullptr) v = round_c(v * v_scale[row], ctag);
      v_s[sl * Dv + d] = v;
    }
    __syncthreads();

    // logits = (q . k) * scale + bias, bias from slot positions only
    for (int i = tid; i < SG * PS; i += THREADS) {
      const int r = i / PS, sl = i % PS;
      const float* qr = q_s + r * QST;
      const float* kr = k_s + sl * KST;
      float dot = 0.0f;
      for (int d = 0; d < Dk; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int qp = q_pos[(size_t)b * S + s_lo + r / G];
      const int kp = pos_s[sl];
      bool valid = kp >= 0 && kp <= qp;
      if (window > 0) valid = valid && kp > qp - window;
      p_s[i] = dot * scale + (valid ? 0.0f : NEG_INF);
    }
    __syncthreads();

    // online-softmax statistics, one thread per query row
    for (int r = tid; r < SG; r += THREADS) {
      float* pr = p_s + r * PS;
      float m_cur = pr[0];
      for (int sl = 1; sl < PS; ++sl) m_cur = fmaxf(m_cur, pr[sl]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int sl = 0; sl < PS; ++sl) {
        const float e = expf(pr[sl] - m_new);
        sum += e;
        pr[sl] = e;
      }
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + probs(cast to the value dtype) @ v
    const float* vv = latent ? k_s : v_s;
    const int vst = latent ? KST : Dv;
    for (int i = tid; i < SG * Dv; i += THREADS) {
      const int r = i / Dv, d = i % Dv;
      const float* pr = p_s + r * PS;
      float pv = 0.0f;
      for (int sl = 0; sl < PS; ++sl) pv = fmaf(round_c(pr[sl], ctag), vv[sl * vst + d], pv);
      acc_s[i] = acc_s[i] * a_s[r] + pv;
    }
  }
  __syncthreads();
  // this split's partial statistics over all S * G rows of the (request,
  // KV head): acc [S*G][Dv], then m [S*G], then l [S*G]; this block owns
  // rows [s_lo * G, s_lo * G + SG)
  float* w = ws + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * SGALL * (Dv + 2);
  const int r0 = s_lo * G;
  for (int i = tid; i < SG * Dv; i += THREADS) w[r0 * Dv + i] = acc_s[i];
  for (int r = tid; r < SG; r += THREADS) {
    w[SGALL * Dv + r0 + r] = m_s[r];
    w[SGALL * Dv + SGALL + r0 + r] = l_s[r];
  }
}

// Merge the splits, one thread per output element of (request, KV head,
// row, feature): out = sum_j e_j acc_j / max(sum_j e_j l_j, 1e-30) with
// e_j = exp(m_j - max_j m_j), summed in split order over the splits with
// l_j > 0 (a split that took no page for the row adds nothing).  Three
// walks over a row's splits.  EVERY, when every split wrote every row's
// acc (the scalar and the GQA kernels): one split after another, its
// loads independent of the sums.  The latent kernel writes no acc for a
// row with l == 0, and takes one of two walks of the same arithmetic (so
// the same bits): GROUPED, CB splits at a time with their (m, l) and then
// the acc they need all in flight, where a call has few outputs (decode:
// too few threads hide the latency), and SKIPPING, one split after
// another, reading an acc only where l > 0.
enum Walk { EVERY, GROUPED, SKIPPING };
constexpr int CB = 8;
constexpr size_t GROUPED_BELOW = 1 << 17;  // outputs of a call

__device__ __forceinline__ void merge_split(float e, float lj, float aj, float& l, float& acc) {
  if (lj > 0.0f) {
    l = __fmaf_rn(e, lj, l);
    acc = __fmaf_rn(e, aj, acc);
  }
}

template <typename CT, Walk WALK>
__global__ void __launch_bounds__(THREADS)
paged_attn_combine(const float* __restrict__ ws, CT* __restrict__ out, int B, int S,
                   int H, int KV, int Dv, int nsplit) {
  const int G = H / KV, SG = S * G;
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * KV * SG * Dv) return;
  const int d = (int)(i % Dv);
  const size_t row = i / Dv;  // (b * KV + kvh) * SG + r
  const int r = (int)(row % SG), bk = (int)(row / SG);
  const int b = bk / KV, kvh = bk % KV, s = r / G, g = r % G;
  const size_t stride = (size_t)SG * (Dv + 2);
  const float* base = ws + (size_t)bk * nsplit * stride;
  const float* ms = base + (size_t)SG * Dv + r;
  const float* ls = ms + SG;
  const float* as = base + (size_t)r * Dv + d;
  float m = NEG_INF;
  for (int j = 0; j < nsplit; ++j) m = fmaxf(m, ms[j * stride]);
  float l = 0.0f, acc = 0.0f;
  if constexpr (WALK == EVERY) {  // a split with l_j == 0 adds e_j * 0
    for (int j = 0; j < nsplit; ++j) {
      const float e = expf(ms[j * stride] - m);
      l += e * ls[j * stride];
      acc += e * as[j * stride];
    }
  } else if constexpr (WALK == GROUPED) {
    for (int j0 = 0; j0 < nsplit; j0 += CB) {
      float mj[CB], lj[CB], aj[CB];
#pragma unroll
      for (int u = 0; u < CB; ++u) {
        const bool in = j0 + u < nsplit;
        mj[u] = in ? ms[(j0 + u) * stride] : NEG_INF;
        lj[u] = in ? ls[(j0 + u) * stride] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < CB; ++u) aj[u] = lj[u] > 0.0f ? as[(j0 + u) * stride] : 0.0f;
#pragma unroll
      for (int u = 0; u < CB; ++u) merge_split(expf(mj[u] - m), lj[u], aj[u], l, acc);
    }
  } else {
    for (int j = 0; j < nsplit; ++j) {
      const float lj = ls[j * stride];
      if (lj > 0.0f) merge_split(expf(ms[j * stride] - m), lj, as[j * stride], l, acc);
    }
  }
  store(out + (((size_t)b * S + s) * H + kvh * G + g) * Dv + d, acc / fmaxf(l, 1e-30f));
}

// the combine kernel's launch for B * S * H rows of Dv outputs; all_acc:
// every split wrote every row's acc
template <typename CT>
cudaError_t combine(const float* ws, void* out, int B, int S, int H, int KV, int Dv, int nsplit,
                    bool all_acc, cudaStream_t stream) {
  const size_t total = (size_t)B * S * H * Dv;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  auto kernel = all_acc ? paged_attn_combine<CT, EVERY>
                        : total < GROUPED_BELOW ? paged_attn_combine<CT, GROUPED>
                                                : paged_attn_combine<CT, SKIPPING>;
  kernel<<<blocks, THREADS, 0, stream>>>(ws, (CT*)out, B, S, H, KV, Dv, nsplit);
  return cudaGetLastError();
}

int s_block(int G) { return G >= ROWS ? 1 : ROWS / G; }

size_t smem_bytes(int S, int G, int Dk, int Dv, int PS, int latent) {
  const size_t SG = (size_t)(S < s_block(G) ? S : s_block(G)) * G;
  const size_t v_tile = latent ? 0 : (size_t)PS * Dv;
  return sizeof(float) * (SG * (Dk + 1) + (size_t)PS * (Dk + 1) + v_tile + SG * PS +
                          SG * Dv + 3 * SG + Dv) +
         sizeof(int32_t) * PS;
}

template <typename KT, typename CT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int32_t* pos, const int32_t* tables,
                   const int32_t* qpos, float* ws, void* out, int B, int S, int H, int KV,
                   int Dk, int Dv, int PS, int P, int pages_per_split, int window,
                   int latent, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, H / KV, Dk, Dv, PS, latent);
  cudaError_t err = cudaFuncSetAttribute(paged_attn_kernel<KT, CT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int nsplit = (P + pages_per_split - 1) / pages_per_split;
  const int s_blk = s_block(H / KV);
  const int nrow = (S + s_blk - 1) / s_blk;
  paged_attn_kernel<KT, CT><<<dim3(B * KV, nsplit, nrow), THREADS, smem, stream>>>(
      (const CT*)q, (const KT*)k, (const KT*)v, ks, vs, pos, tables, qpos, ws, S, H, KV,
      Dk, Dv, PS, P, pages_per_split, s_blk, window, latent, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine<CT>(ws, out, B, S, H, KV, Dv, nsplit, true, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core kernels: bf16 GQA and bf16 latent.

typedef __nv_bfloat16 bf16;

constexpr int TC_MAX_PS = 64;   // slots of a sub-page, at most (8 n-tiles of the S fragment)
constexpr int TC_MAX_PPS = 32;  // pages of a split: one ballot covers them
constexpr int TC_STAGES = 2;    // sub-pages of the ring: one in use, one in flight
// The latent kernel's block: LT_MTILES m-tiles of 16 query rows taken
// across token boundaries, each served by LT_WARPS warps that compute the
// same S fragment and own 1 / LT_WARPS of Dv's columns each.
constexpr int LT_MTILES = 4;
constexpr int LT_WARPS = 2;
constexpr int LT_THREADS = LT_MTILES * LT_WARPS * 32;
constexpr int LT_MAX_DV = 256;
constexpr int LT_NVW = LT_MAX_DV / 8 / LT_WARPS;  // accumulator n-tiles of one warp

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A page of PS slots is walked as n sub-pages of sps = min(PS, 64) slots
// (the last holds PS - (n - 1) * sps), each its own pass of the S
// fragment; a page of at most 64 slots is one sub-page.  A page's slot
// positions sit in shared memory as n runs of sps8 = sps rounded up to 8
// (the pad slots -1), psp in all.
struct SubPages {
  int n, sps, sps8, psp;
};

__host__ __device__ inline SubPages sub_pages(int PS) {
  const int sps = PS < TC_MAX_PS ? PS : TC_MAX_PS, n = (PS + sps - 1) / sps;
  return SubPages{n, sps, round_up(sps, 8), n * round_up(sps, 8)};
}

// Byte offsets of a tensor-core kernel's dynamic shared memory.  bf16
// pages: a K (and, GQA, a V) tile per stage of the ring.  int8 pages: raw
// rows and scales per stage, dequantized into one K (and V) tile.  A tile
// holds one sub-page.  Tile rows are padded by 8 bf16 (16 bytes), after
// Dk rounded up to 16 (the k-step of Q K^T; the latent mode's Dk may be a
// multiple of 8 only, and its extra columns are zero in q and K).  The K
// tile has the sub-page's slots rounded up to 8 rows (the S fragment's
// n-tile) and the V tile rounded up to 16 rows (P V's k-step), the extra
// rows zero; in latent mode the K tile is also V's, so it has the 16-row
// rounding and there is no V tile.  Slot positions are [pps][psp].
struct TcLayout {
  size_t q, kt, vt, kraw, vraw, ks, vs, pos, pid, vsum, total;
};

__host__ __device__ inline TcLayout tc_layout(int rows16, int Dk, int Dv, int PS, int pps,
                                              bool int8, bool latent) {
  TcLayout L;
  const SubPages sp = sub_pages(PS);
  const size_t sps = sp.sps, ps8 = round_up(sp.sps, 8), ps16 = round_up(sp.sps, 16);
  const size_t dkp = round_up(Dk, 16) + 8;
  const size_t krows = latent ? ps16 : ps8;
  const size_t tiles = int8 ? 1 : TC_STAGES, raw = int8 ? TC_STAGES : 0;
  const size_t vtiles = latent ? 0 : tiles, vraw = latent ? 0 : raw;
  size_t o = 0;
  L.q = o;     o = align16(o + (size_t)rows16 * dkp * sizeof(bf16));
  L.kt = o;    o = align16(o + tiles * krows * dkp * sizeof(bf16));
  L.vt = o;    o = align16(o + vtiles * ps16 * (Dv + 8) * sizeof(bf16));
  L.kraw = o;  o = align16(o + raw * sps * Dk);
  L.vraw = o;  o = align16(o + vraw * sps * Dv);
  L.ks = o;    o = align16(o + raw * sps * sizeof(float));
  L.vs = o;    o = align16(o + vraw * sps * sizeof(float));
  L.pos = o;   o = align16(o + (size_t)pps * sp.psp * sizeof(int32_t));
  L.pid = o;   o = align16(o + (size_t)pps * sizeof(int32_t));
  L.vsum = o;  o = align16(o + (size_t)Dv * sizeof(float));
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// the same, copying only when `full` and else writing 16 zero bytes (a
// sub-page's rows past its last slot)
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

__device__ __forceinline__ void cp_async4z(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a sub-page's n scales (f32) into the first of sps shared slots, the rest
// zero: 16-byte copies when every sub-page's scales are 16-byte aligned
// (PS % 4 == 0, so sps and n are multiples of 4 too), else one float a
// thread
__device__ __forceinline__ void cp_async_scales(float* dst, const float* src, int n, int sps,
                                                int PS) {
  const int tid = threadIdx.x;
  if (PS % 4 == 0) {
    if (tid < sps / 4) cp_async16z(dst + tid * 4, tid * 4 < n ? src + tid * 4 : src, tid * 4 < n);
  } else if (tid < sps) {
    cp_async4z(dst + tid, tid < n ? src + tid : src, tid < n);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool key_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// The logit bias of slot `sl` for a query at qp: 0 for a valid key,
// NEG_INF for a real slot that is not (so a row with no valid key takes
// exp(NEG_INF - NEG_INF) = 1 there, the plain version's uniform mean), and
// -inf for a pad slot past the sub-page's n slots, which must add nothing
// to any row.
__device__ __forceinline__ float slot_bias(int sl, int n, int kp, int qp, int window) {
  return sl >= n ? -INFINITY : (key_valid(kp, qp, window) ? 0.0f : NEG_INF);
}

// A [rows][n] grid of 16- or 8-byte chunks dealt to a block's NT threads
// once: thread t takes chunk c = t % n of rows t / n, t / n + step, ...
// with step = NT / n (threads from step * n on take none), so no page's
// copy or dequantization divides.  n <= NT.
struct Grid {
  int c, r0, step;
};

template <int NT>
__device__ __forceinline__ Grid make_grid(int n) {
  const int t = threadIdx.x, step = NT / n;
  return Grid{t % n, t < step * n ? t / n : 1 << 30, step};
}

// 8 int8 (two words, lowest byte first) -> 8 bf16: round_bf16(f32(q) * s),
// the scalar kernel's dequantization
__device__ __forceinline__ uint4 dequant8(uint32_t lo, uint32_t hi, float s) {
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t word = j < 2 ? lo : hi;
    const int sh = (j % 2) * 16;
    o[j] = pack_bf16((float)(int8_t)(word >> sh) * s, (float)(int8_t)(word >> (sh + 8)) * s);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// What a block learns before its ring: `valid` has bit p set for each
// page of its split with a slot (every warp computes the same mask), and
// `walk_all` says whether a query token of the block has no valid key in
// its whole table (the scalar kernel's scan).
struct Split {
  unsigned valid;
  bool walk_all;
};

// The split's page ids and slot positions into shared memory, read ahead
// of the ring (each page as its sub-pages' runs, pad slots at -1), and
// the keyless scan of the block's query tokens [t0, t1): both read global
// memory before the one barrier, so their latencies overlap.
__device__ __forceinline__ Split read_split(const int32_t* __restrict__ pos_tbl,
                                           const int32_t* __restrict__ table, int p0, int np,
                                           const int32_t* __restrict__ qpos, int t0, int t1,
                                           int P, int PS, SubPages sp, int window, int NT,
                                           int32_t* pos_s, int32_t* pid_s) {
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < np * sp.psp; i += NT) {
    const int p = i / sp.psp, e = i % sp.psp;
    const int sl = sp.n == 1 ? e : e % sp.sps8, slot = sp.n == 1 ? e : e / sp.sps8 * sp.sps + sl;
    const int pid = table[p0 + p];
    pos_s[i] = sl < sp.sps && slot < PS ? pos_tbl[(size_t)pid * PS + slot] : -1;
    if (e == 0) pid_s[p] = pid;
  }
  bool keyless = false;
  for (int t = t0 + tid; t < t1; t += NT) {
    const int qp = qpos[t];
    bool live = false;
    for (int p = 0; qp >= 0 && p < P && !live; ++p) {
      const int pid = table[p];
      for (int sl = 0; sl < PS && !live; ++sl)
        live = key_valid(pos_tbl[(size_t)pid * PS + sl], qp, window);
    }
    keyless |= !live;
  }
  const bool walk_all = __syncthreads_or(keyless);
  bool any = false;
  if (lane < np)
    for (int e = 0; e < sp.psp; ++e) any |= pos_s[lane * sp.psp + e] >= 0;
  return Split{__ballot_sync(0xffffffffu, any), walk_all};
}

// v summed over the split's slot-less pages, per feature d < Dv, into
// vsum_s: slots in order, a run of one page read once and weighted by its
// length.  v is column off + d of the page rows, of stride `stride`,
// dequantized as the ring does (round_bf16(f32(q) * scale)) for int8.
template <typename KT>
__device__ void sum_slotless(const KT* __restrict__ pages, const float* __restrict__ scale,
                             const int32_t* pid_s, unsigned valid, int np, int PS, int Dv,
                             size_t stride, size_t off, int NT, float* vsum_s) {
  for (int d = threadIdx.x; d < Dv; d += NT) {
    float tot = 0.0f;
    for (int p = 0; p < np;) {
      if (valid >> p & 1u) {
        ++p;
        continue;
      }
      const int pid = pid_s[p];
      int reps = 1;
      while (p + reps < np && pid_s[p + reps] == pid) ++reps;
      float sum = 0.0f;
      for (int sl = 0; sl < PS; ++sl) {
        const size_t row = (size_t)pid * PS + sl;
        float v = to_f(pages[row * stride + off + d]);
        if constexpr (std::is_same<KT, int8_t>::value) v = round_c(v * scale[row], (bf16*)nullptr);
        sum += v;
      }
      tot += reps * sum;
      p += reps;
    }
    vsum_s[d] = tot;
  }
  __syncthreads();
}

// Online softmax over one sub-page's S fragment (rows g and g + 8 of the
// m-tile, the thread's quad holding its n slots): scale, mask, row max
// and sum by quad shuffles; sc becomes the probabilities, (m, l) advance
// and acc is rescaled when a row's max moved.
template <int NS, int NVT>
__device__ __forceinline__ void page_softmax(float (&sc)[NS][4], float (&acc)[NVT][4], int ns,
                                             const int32_t* pos, int n, int qp0, int qp1,
                                             int window, float scale, float& m0, float& m1,
                                             float& l0, float& l1) {
  const int tig = threadIdx.x % 4;
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (j >= ns) continue;
    const int sl = j * 8 + 2 * tig;
    const int2 kp = *reinterpret_cast<const int2*>(pos + sl);
    sc[j][0] = sc[j][0] * scale + slot_bias(sl, n, kp.x, qp0, window);
    sc[j][1] = sc[j][1] * scale + slot_bias(sl + 1, n, kp.y, qp0, window);
    sc[j][2] = sc[j][2] * scale + slot_bias(sl, n, kp.x, qp1, window);
    sc[j][3] = sc[j][3] * scale + slot_bias(sl + 1, n, kp.y, qp1, window);
    mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
    mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (j >= ns) continue;
    sc[j][0] = __expf(sc[j][0] - mn0);
    sc[j][1] = __expf(sc[j][1] - mn0);
    sc[j][2] = __expf(sc[j][2] - mn1);
    sc[j][3] = __expf(sc[j][3] - mn1);
    sum0 += sc[j][0] + sc[j][1];
    sum1 += sc[j][2] + sc[j][3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  l0 = al0 * l0 + sum0;
  l1 = al1 * l1 + sum1;
  m0 = mn0;
  m1 = mn1;
  if (__any_sync(0xffffffffu, al0 != 1.0f || al1 != 1.0f)) {  // else x 1 changes nothing
#pragma unroll
    for (int j = 0; j < NVT; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
  }
}

// acc += P V over one page: the bf16-rounded S fragment is P's A fragment
// as it stands; V's B fragments by ldmatrix.trans from `vb` (this lane's
// address in a [slot][feature] tile of row stride `vst`), nvt n-tiles.
template <int NS, int NVT>
__device__ __forceinline__ void page_pv(const float (&sc)[NS][4], float (&acc)[NVT][4], int ns,
                                        const bf16* vb, int vst, int nvt) {
#pragma unroll
  for (int kc = 0; kc < (NS + 1) / 2; ++kc) {
    if (2 * kc >= ns) continue;
    uint32_t a[4];
    a[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
    a[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
    a[2] = 2 * kc + 1 < ns ? pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]) : 0u;
    a[3] = 2 * kc + 1 < ns ? pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]) : 0u;
#pragma unroll
    for (int j = 0; j < NVT; j += 2) {
      uint32_t bb[4];
      if (j + 1 < nvt) {
        ldsm_x4_t(bb, vb + kc * 16 * vst + j * 8);
        mma_bf16(acc[j], a, bb[0], bb[1]);
        mma_bf16(acc[j + 1], a, bb[2], bb[3]);
      } else if (j < nvt) {
        ldsm_x2_t(bb, vb + kc * 16 * vst + j * 8);
        mma_bf16(acc[j], a, bb[0], bb[1]);
      }
    }
  }
}

// The rows that have seen no valid key (m == NEG_INF) take the split's
// slot-less pages: l += their slots, acc += vsum (the thread's columns
// c0 + j * 8 + 2 * tig of its nvt n-tiles); every other row gains nothing.
template <int NVT>
__device__ __forceinline__ void add_slotless(float (&acc)[NVT][4], const float* vsum_s, int c0,
                                             int nvt, float add_l, float m0, float m1,
                                             float& l0, float& l1) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NVT; ++j) {
    if (j < nvt) {
      const float v0 = vsum_s[c0 + j * 8 + 2 * tig], v1 = vsum_s[c0 + j * 8 + 2 * tig + 1];
      if (m0 == NEG_INF) {
        acc[j][0] += v0;
        acc[j][1] += v1;
      }
      if (m1 == NEG_INF) {
        acc[j][2] += v0;
        acc[j][3] += v1;
      }
    }
  }
  if (m0 == NEG_INF) l0 += add_l;
  if (m1 == NEG_INF) l1 += add_l;
}

// One row's result: with one split the output itself, acc / max(l, 1e-30)
// as the combine kernel computes it (`o` is the row's output); else this
// split's partial for the combine, in the workspace layout (acc [SG][Dv],
// then m [SG], then l [SG]) at row rr of `w`.  Unless ALL_ACC, a row that
// took no page of this split (l == 0, acc == 0) writes only (m, l) and the
// combine skips its acc.  `stats` marks the thread that writes (m, l).
template <int NVT, bool ALL_ACC>
__device__ __forceinline__ void store_row(const float (&acc)[NVT][4], int h, float m, float l,
                                          int nvt, int c0, bool one_split, bf16* o, float* w,
                                          int rr, int SG, int Dv, bool stats) {
  const int tig = threadIdx.x % 4;
  if (one_split) {
    const float lden = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NVT; ++j)
      if (j < nvt)
        *reinterpret_cast<uint32_t*>(o + c0 + j * 8 + 2 * tig) =
            pack_bf16(acc[j][2 * h] / lden, acc[j][2 * h + 1] / lden);
    return;
  }
  if (ALL_ACC || l > 0.0f) {
#pragma unroll
    for (int j = 0; j < NVT; ++j)
      if (j < nvt)
        *reinterpret_cast<float2*>(w + (size_t)rr * Dv + c0 + j * 8 + 2 * tig) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
  if (stats) {
    w[(size_t)SG * Dv + rr] = m;
    w[(size_t)SG * Dv + SG + rr] = l;
  }
}

// KT: page storage (int8_t with scale planes, or bf16).  NVT: n-tiles of
// 8 output features the accumulator holds (Dv <= 8 * NVT).  NS: n-tiles of
// 8 slots a sub-page's S fragment holds (min(PS, 64) <= 8 * NS).  SUB:
// pages of more than 64 slots, walked as sub-pages (else a page is one
// sub-page and the walk keeps no sub-page count).
template <typename KT, int NVT, int NS, bool SUB>
__global__ void __launch_bounds__(THREADS)
paged_attn_tc_kernel(const bf16* __restrict__ q, const KT* __restrict__ k_pages,
                     const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int32_t* __restrict__ pos_tbl,
                     const int32_t* __restrict__ page_tables, const int32_t* __restrict__ q_pos,
                     float* __restrict__ ws, bf16* __restrict__ out, int S, int H, int KV,
                     int Dk, int Dv, int PS, int P, int pps, int s_blk, int window,
                     float scale) {
  constexpr bool INT8 = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV, SGALL = S * G;
  const int s_lo = blockIdx.z * s_blk;
  const int SG = (min(S, s_lo + s_blk) - s_lo) * G;
  const int rows16 = (min(S, s_blk) * G + 15) / 16 * 16;
  const int p0 = blockIdx.y * pps, np = min(P, p0 + pps) - p0;
  const SubPages sb = SUB ? sub_pages(PS) : SubPages{1, PS, round_up(PS, 8), round_up(PS, 8)};
  const int SPS = sb.sps, DkP = Dk + 8, DvP = Dv + 8, ps8 = round_up(SPS, 8),
            ps16 = round_up(SPS, 16);
  const int kvd_k = KV * Dk, kvd_v = KV * Dv;
  const TcLayout L = tc_layout(rows16, Dk, Dv, PS, pps, INT8, false);
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem + L.q);
  bf16* kt_s = reinterpret_cast<bf16*>(tc_smem + L.kt);
  bf16* vt_s = reinterpret_cast<bf16*>(tc_smem + L.vt);
  int8_t* kraw_s = reinterpret_cast<int8_t*>(tc_smem + L.kraw);
  int8_t* vraw_s = reinterpret_cast<int8_t*>(tc_smem + L.vraw);
  float* ks_s = reinterpret_cast<float*>(tc_smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(tc_smem + L.vs);
  int32_t* pos_s = reinterpret_cast<int32_t*>(tc_smem + L.pos);  // [pps][psp]
  int32_t* pid_s = reinterpret_cast<int32_t*>(tc_smem + L.pid);  // [pps]
  float* vsum_s = reinterpret_cast<float*>(tc_smem + L.vsum);    // [Dv]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // q rows -> shared memory (one cp.async group, in flight while the split
  // is read); rows past SG are zero
  const int qc = Dk / 8;
  for (int i = tid; i < rows16 * qc; i += THREADS) {
    const int r = i / qc, c = i % qc;
    bf16* dst = q_s + r * DkP + c * 8;
    if (r < SG) {
      const int s = s_lo + r / G, g = r % G;
      cp_async16(dst, q + (((size_t)b * S + s) * H + kvh * G + g) * Dk + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_commit();
  // tile rows past a sub-page's slots stay zero (the ring zero-fills those
  // under sps, these are past it): a pad slot's logit is -inf and its P 0,
  // and 0 times a stale NaN would not be
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int t = 0; t < (INT8 ? 1 : TC_STAGES); ++t) {
    for (int i = tid; i < (ps8 - SPS) * DkP; i += THREADS)
      kt_s[(size_t)t * ps8 * DkP + SPS * DkP + i] = zero;
    for (int i = tid; i < (ps16 - SPS) * DvP; i += THREADS)
      vt_s[(size_t)t * ps16 * DvP + SPS * DvP + i] = zero;
  }
  const Split sp = read_split(pos_tbl, page_tables + (size_t)b * P, p0, np,
                              q_pos + (size_t)b * S, s_lo, s_lo + SG / G, P, PS, sb, window,
                              THREADS, pos_s, pid_s);
  const unsigned valid = sp.valid;
  const int nv = __popc(valid);

  // this thread's rows of its warp's m-tile: g and g + 8
  const int gq = lane / 4, tig = lane % 4;
  const int r0 = warp * 16 + gq, r1 = r0 + 8;
  const bool active = warp * 16 < SG;
  const int qp0 = r0 < SG ? q_pos[(size_t)b * S + s_lo + r0 / G] : -1;
  const int qp1 = r1 < SG ? q_pos[(size_t)b * S + s_lo + r1 / G] : -1;
  const int nvt = Dv / 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
  float acc[NVT][4];
#pragma unroll
  for (int j = 0; j < NVT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  // The ring: TC_STAGES - 1 sub-pages in flight ahead of the one in use,
  // one cp.async group per sub-page (empty past the last, so the count is
  // uniform); a page with a slot enters as all its sub-pages, in order.  K
  // rows go in 16-byte chunks; V rows too, or in 8-byte ones for int8 rows
  // whose width is not a multiple of 16.  A sub-page's tile rows past its
  // slots are zero-filled.
  constexpr int KB = sizeof(KT);
  const int vbytes = (Dv * KB) % 16 == 0 ? 16 : 8;
  const Grid kg = make_grid<THREADS>(Dk * KB / 16), vg = make_grid<THREADS>(Dv * KB / vbytes);
  const KT* kbase = k_pages + (size_t)kvh * Dk + kg.c * (16 / KB);
  const KT* vbase = v_pages + (size_t)kvh * Dv + vg.c * (vbytes / KB);
  unsigned ahead = valid, cur = valid;
  int a_sub = 0, c_sub = 0;  // sub-page of the next page to issue / to walk
  auto issue_next = [&](int st) {  // the next sub-page of a page with a slot into stage st
    if (ahead) {
      const int j = SUB ? a_sub : 0, n = SUB ? min(SPS, PS - j * SPS) : SPS;
      const size_t row0 = (size_t)pid_s[__ffs(ahead) - 1] * PS + (size_t)j * SPS;
      if (!SUB || ++a_sub == sb.n) {
        a_sub = 0;
        ahead &= ahead - 1;
      }
      const KT* ksrc = kbase + row0 * kvd_k;
      const KT* vsrc = vbase + row0 * kvd_v;
      if constexpr (INT8) {
        int8_t* kd = kraw_s + (size_t)st * SPS * Dk + kg.c * 16;
        int8_t* vd = vraw_s + (size_t)st * SPS * Dv + vg.c * vbytes;
        for (int r = kg.r0; r < SPS; r += kg.step) {
          const bool full = !SUB || r < n;  // rows past a sub-page's slots: zero
          cp_async16z(kd + r * Dk, ksrc + (size_t)(full ? r : 0) * kvd_k, full);
        }
        for (int r = vg.r0; r < SPS; r += vg.step) {
          const bool full = !SUB || r < n;
          const KT* src = vsrc + (size_t)(full ? r : 0) * kvd_v;
          if (vbytes == 16) cp_async16z(vd + r * Dv, src, full);
          else cp_async8z(vd + r * Dv, src, full);
        }
        cp_async_scales(ks_s + st * SPS, k_scale + row0, n, SPS, PS);
        cp_async_scales(vs_s + st * SPS, v_scale + row0, n, SPS, PS);
      } else {
        bf16* kd = kt_s + (size_t)st * ps8 * DkP + kg.c * 8;
        bf16* vd = vt_s + (size_t)st * ps16 * DvP + vg.c * 8;
        for (int r = kg.r0; r < SPS; r += kg.step) {
          const bool full = !SUB || r < n;
          cp_async16z(kd + r * DkP, ksrc + (size_t)(full ? r : 0) * kvd_k, full);
        }
        for (int r = vg.r0; r < SPS; r += vg.step) {
          const bool full = !SUB || r < n;
          cp_async16z(vd + r * DvP, vsrc + (size_t)(full ? r : 0) * kvd_v, full);
        }
      }
    }
    cp_commit();
  };
  for (int j = 0; j < TC_STAGES - 1; ++j) issue_next(j);

  for (int i = 0; i < nv * sb.n; ++i) {
    const int st = i % TC_STAGES;
    const int page = __ffs(cur) - 1, sj = SUB ? c_sub : 0;
    const int n = SUB ? min(SPS, PS - sj * SPS) : SPS;
    if (!SUB || ++c_sub == sb.n) {
      c_sub = 0;
      cur &= cur - 1;
    }
    cp_wait<TC_STAGES - 2>();  // sub-page i (and, first, q) landed
    __syncthreads();           // ... for every thread; sub-page i - 1 fully consumed
    issue_next((i + TC_STAGES - 1) % TC_STAGES);
    const bf16* kt;
    const bf16* vt;
    if constexpr (INT8) {  // the thread's own grid chunks, into the bf16 tiles
      const int8_t* kr = kraw_s + (size_t)st * SPS * Dk + kg.c * 16;
      const int8_t* vr = vraw_s + (size_t)st * SPS * Dv + vg.c * vbytes;
      const float* ks = ks_s + st * SPS;
      const float* vs = vs_s + st * SPS;
      for (int r = kg.r0; r < SPS; r += kg.step) {
        const uint4 w = *reinterpret_cast<const uint4*>(kr + r * Dk);
        bf16* o = kt_s + r * DkP + kg.c * 16;
        *reinterpret_cast<uint4*>(o) = dequant8(w.x, w.y, ks[r]);
        *reinterpret_cast<uint4*>(o + 8) = dequant8(w.z, w.w, ks[r]);
      }
      for (int r = vg.r0; r < SPS; r += vg.step) {
        bf16* o = vt_s + r * DvP + vg.c * vbytes;
        if (vbytes == 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(vr + r * Dv);
          *reinterpret_cast<uint4*>(o) = dequant8(w.x, w.y, vs[r]);
          *reinterpret_cast<uint4*>(o + 8) = dequant8(w.z, w.w, vs[r]);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(vr + r * Dv);
          *reinterpret_cast<uint4*>(o) = dequant8(w.x, w.y, vs[r]);
        }
      }
      __syncthreads();
      kt = kt_s;
      vt = vt_s;
    } else {
      kt = kt_s + (size_t)st * ps8 * DkP;
      vt = vt_s + (size_t)st * ps16 * DvP;
    }
    if (!active) continue;
    const int ns = (n + 7) / 8;  // n-tiles of the S fragment this sub-page fills

    // S = Q K^T: A from q's rows, B = K rows (ldmatrix: K^T's columns)
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
    const bf16* qa = q_s + (warp * 16 + lane % 8 + ((lane / 8) % 2) * 8) * DkP + (lane / 16) * 8;
    const bf16* kb = kt + (lane % 8 + (lane / 16) * 8) * DkP + ((lane / 8) % 2) * 8;
    for (int kk = 0; kk < Dk; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bb[4];
        if (j + 1 < ns) {
          ldsm_x4(bb, kb + j * 8 * DkP + kk);
          mma_bf16(sc[j], a, bb[0], bb[1]);
          mma_bf16(sc[j + 1], a, bb[2], bb[3]);
        } else if (j < ns) {
          ldsm_x2(bb, kb + j * 8 * DkP + kk);
          mma_bf16(sc[j], a, bb[0], bb[1]);
        }
      }
    }
    page_softmax<NS, NVT>(sc, acc, ns, pos_s + page * sb.psp + sj * ps8, n, qp0, qp1, window,
                          scale, m0, m1, l0, l1);
    const bf16* vb = vt + (lane % 8 + ((lane / 8) % 2) * 8) * DvP + (lane / 16) * 8;
    page_pv<NS, NVT>(sc, acc, ns, vb, DvP, nvt);
  }
  cp_wait<0>();  // nothing in flight at exit (q's group when no page has a slot)

  // slot-less pages: every logit NEG_INF exactly, so only rows that have
  // seen no valid key gain: l += PS and acc += the page's v rows summed in
  // slot order, per page; a run of one page is read once
  if (sp.walk_all && nv < np) {  // uniform across the block
    sum_slotless<KT>(v_pages, v_scale, pid_s, valid, np, PS, Dv, kvd_v, (size_t)kvh * Dv,
                     THREADS, vsum_s);
    if (active)
      add_slotless<NVT>(acc, vsum_s, 0, nvt, (float)((np - nv) * PS), m0, m1, l0, l1);
  }
  if (!active) return;

  const int rows[2] = {r0, r1};
  const float ls[2] = {l0, l1}, ms[2] = {m0, m1};
  float* w = ws + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * SGALL * (Dv + 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    if (r >= SG) continue;
    const int s = s_lo + r / G, g = r % G;
    store_row<NVT, true>(acc, h, ms[h], ls[h], nvt, 0, gridDim.y == 1,
                   out + (((size_t)b * S + s) * H + kvh * G + g) * Dv, w, s_lo * G + r, SGALL, Dv,
                   tig == 0);
  }
}

// The latent kernel (bf16 MLA, KV = 1): the S * G query rows of a request
// form one row space, r = s * G + g, and a block takes LT_MTILES * 16 of
// them across token boundaries, so a page is copied (and dequantized)
// once per row tile, not once per token.  Each m-tile has LT_WARPS warps:
// they compute the same S fragment from the same q rows and K tile, and
// each accumulates its own 1 / LT_WARPS of Dv's columns; one K tile serves
// both products (Q K^T over all Dk columns, P V over its first Dv).
// KT: page storage; NS: n-tiles of 8 slots of the S fragment (min(PS, 64)
// <= 8 NS); SUB as the GQA kernel's.
template <typename KT, int NS, bool SUB>
__global__ void __launch_bounds__(LT_THREADS)
paged_attn_latent_tc_kernel(const bf16* __restrict__ q, const KT* __restrict__ k_pages,
                            const float* __restrict__ k_scale,
                            const int32_t* __restrict__ pos_tbl,
                            const int32_t* __restrict__ page_tables,
                            const int32_t* __restrict__ q_pos, float* __restrict__ ws,
                            bf16* __restrict__ out, int S, int G, int Dk, int Dv, int PS, int P,
                            int pps, int window, float scale) {
  constexpr bool INT8 = std::is_same<KT, int8_t>::value;
  constexpr int NT = LT_THREADS, RT = LT_MTILES * 16, NVW = LT_NVW;
  // Q K^T sums the even and the odd k-steps in separate fragments (then
  // adds them), halving its chain of dependent mma
  constexpr int KSETS = NS <= 2 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int b = blockIdx.x, SG = S * G;
  const int r_lo = blockIdx.z * RT, nr = min(RT, SG - r_lo);
  const int p0 = blockIdx.y * pps, np = min(P, p0 + pps) - p0;
  const SubPages sb = SUB ? sub_pages(PS) : SubPages{1, PS, round_up(PS, 8), round_up(PS, 8)};
  const int SPS = sb.sps, DkR = round_up(Dk, 16), DkP = DkR + 8, ps8 = round_up(SPS, 8),
            ps16 = round_up(SPS, 16);
  const TcLayout L = tc_layout(RT, Dk, Dv, PS, pps, INT8, true);
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem + L.q);
  bf16* kt_s = reinterpret_cast<bf16*>(tc_smem + L.kt);
  int8_t* kraw_s = reinterpret_cast<int8_t*>(tc_smem + L.kraw);
  float* ks_s = reinterpret_cast<float*>(tc_smem + L.ks);
  int32_t* pos_s = reinterpret_cast<int32_t*>(tc_smem + L.pos);  // [pps][psp]
  int32_t* pid_s = reinterpret_cast<int32_t*>(tc_smem + L.pid);  // [pps]
  float* vsum_s = reinterpret_cast<float*>(tc_smem + L.vsum);    // [Dv]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // K tile rows past a sub-page's slots stay zero (a pad slot's P is 0; 0 x
  // a stale NaN is not), and so do the columns from Dk to DkR (they add 0
  // to Q K^T)
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int t = 0; t < (INT8 ? 1 : TC_STAGES); ++t) {
    bf16* tile = kt_s + (size_t)t * ps16 * DkP;
    for (int i = tid; i < (ps16 - SPS) * DkP; i += NT) tile[SPS * DkP + i] = zero;
    for (int i = tid; i < SPS * (DkR - Dk); i += NT)
      tile[i / (DkR - Dk) * DkP + Dk + i % (DkR - Dk)] = zero;
  }
  const Split sp = read_split(pos_tbl, page_tables + (size_t)b * P, p0, np,
                              q_pos + (size_t)b * S, r_lo / G, (r_lo + nr - 1) / G + 1, P, PS,
                              sb, window, NT, pos_s, pid_s);
  const unsigned valid = sp.valid;
  const int nv = __popc(valid);
  // A split with no page to walk for any row of the tile (no slot, no
  // keyless token) adds nothing: its rows' partials are only (m, l) =
  // (NEG_INF, 0), which the combine skips, and the block leaves before it
  // copies q (tables padded with the null page give many such blocks).
  if (nv == 0 && !sp.walk_all && gridDim.y > 1) {  // uniform across the block
    float* ml = ws + ((size_t)b * gridDim.y + blockIdx.y) * SG * (Dv + 2) + (size_t)SG * Dv;
    for (int r = tid; r < nr; r += NT) {
      ml[r_lo + r] = NEG_INF;
      ml[SG + r_lo + r] = 0.0f;
    }
    return;
  }
  // q rows -> shared memory (one cp.async group), for the products only;
  // with KV = 1 a request's rows are contiguous in q; rows past the
  // request's last, and the columns from Dk to DkR, are zero
  const int qc = Dk / 8, qcr = DkR / 8;
  const bf16* qb = q + ((size_t)b * SG + r_lo) * Dk;
  for (int i = tid; i < (nv ? RT * qcr : 0); i += NT) {
    const int r = i / qcr, c = i % qcr;
    bf16* dst = q_s + r * DkP + c * 8;
    if (r < nr && c < qc) cp_async16(dst, qb + (size_t)r * Dk + c * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_commit();

  // this warp's m-tile and columns; this thread's rows g and g + 8 of it
  const int mt = warp / LT_WARPS, nvt = Dv / 8;
  const int w_nvt = (nvt + LT_WARPS - 1) / LT_WARPS;  // n-tiles a warp owns, at most
  const int c0 = (warp % LT_WARPS) * w_nvt * 8;       // its first column
  const int my_nvt = max(0, min(w_nvt, nvt - c0 / 8));
  const int gq = lane / 4, tig = lane % 4;
  const int r0 = mt * 16 + gq, r1 = r0 + 8;  // rows of the tile
  const bool active = mt * 16 < nr;
  const int qp0 = r0 < nr ? q_pos[(size_t)b * S + (r_lo + r0) / G] : -1;
  const int qp1 = r1 < nr ? q_pos[(size_t)b * S + (r_lo + r1) / G] : -1;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
  float acc[NVW][4];
#pragma unroll
  for (int j = 0; j < NVW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  // the ring, as the GQA kernel's: K rows in 16-byte chunks (a bf16
  // latent row is Dk / 8 of them, an int8 one Dk / 16), or 8-byte ones for
  // int8 rows whose width is not a multiple of 16, and the scales
  constexpr int KB = sizeof(KT);
  const int kcb = (Dk * KB) % 16 == 0 ? 16 : 8;
  const Grid kg = make_grid<NT>(Dk * KB / kcb);
  const KT* kbase = k_pages + kg.c * (kcb / KB);
  unsigned ahead = valid, cur = valid;
  int a_sub = 0, c_sub = 0;  // sub-page of the next page to issue / to walk
  auto issue_next = [&](int st) {  // the next sub-page of a page with a slot into stage st
    if (ahead) {
      const int j = SUB ? a_sub : 0, n = SUB ? min(SPS, PS - j * SPS) : SPS;
      const size_t row0 = (size_t)pid_s[__ffs(ahead) - 1] * PS + (size_t)j * SPS;
      if (!SUB || ++a_sub == sb.n) {
        a_sub = 0;
        ahead &= ahead - 1;
      }
      const KT* ksrc = kbase + row0 * Dk;
      if constexpr (INT8) {
        int8_t* kd = kraw_s + (size_t)st * SPS * Dk + kg.c * kcb;
        for (int r = kg.r0; r < SPS; r += kg.step) {
          const bool full = !SUB || r < n;  // rows past a sub-page's slots: zero
          const KT* src = ksrc + (size_t)(full ? r : 0) * Dk;
          if (kcb == 16) cp_async16z(kd + r * Dk, src, full);
          else cp_async8z(kd + r * Dk, src, full);
        }
        cp_async_scales(ks_s + st * SPS, k_scale + row0, n, SPS, PS);
      } else {
        bf16* kd = kt_s + (size_t)st * ps16 * DkP + kg.c * 8;
        for (int r = kg.r0; r < SPS; r += kg.step) {
          const bool full = !SUB || r < n;
          cp_async16z(kd + r * DkP, ksrc + (size_t)(full ? r : 0) * Dk, full);
        }
      }
    }
    cp_commit();
  };
  for (int j = 0; j < TC_STAGES - 1; ++j) issue_next(j);

  const bf16* qa = q_s + (mt * 16 + lane % 8 + ((lane / 8) % 2) * 8) * DkP + (lane / 16) * 8;
  for (int i = 0; i < nv * sb.n; ++i) {
    const int st = i % TC_STAGES;
    const int page = __ffs(cur) - 1, sj = SUB ? c_sub : 0;
    const int n = SUB ? min(SPS, PS - sj * SPS) : SPS;
    if (!SUB || ++c_sub == sb.n) {
      c_sub = 0;
      cur &= cur - 1;
    }
    cp_wait<TC_STAGES - 2>();  // sub-page i (and, first, q) landed
    __syncthreads();           // ... for every thread; sub-page i - 1 fully consumed
    issue_next((i + TC_STAGES - 1) % TC_STAGES);
    const bf16* kt;
    if constexpr (INT8) {  // the thread's own grid chunks, into the bf16 tile
      const int8_t* kr = kraw_s + (size_t)st * SPS * Dk + kg.c * kcb;
      const float* ks = ks_s + st * SPS;
      for (int r = kg.r0; r < SPS; r += kg.step) {
        bf16* o = kt_s + r * DkP + kg.c * kcb;
        if (kcb == 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(kr + r * Dk);
          *reinterpret_cast<uint4*>(o) = dequant8(w.x, w.y, ks[r]);
          *reinterpret_cast<uint4*>(o + 8) = dequant8(w.z, w.w, ks[r]);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(kr + r * Dk);
          *reinterpret_cast<uint4*>(o) = dequant8(w.x, w.y, ks[r]);
        }
      }
      __syncthreads();
      kt = kt_s;
    } else {
      kt = kt_s + (size_t)st * ps16 * DkP;
    }
    if (!active) continue;
    const int ns = (n + 7) / 8;  // n-tiles of the S fragment this sub-page fills

    // S = Q K^T over all DkR columns
    float sk[KSETS][NS][4];
#pragma unroll
    for (int e = 0; e < KSETS; ++e)
#pragma unroll
      for (int j = 0; j < NS; ++j) sk[e][j][0] = sk[e][j][1] = sk[e][j][2] = sk[e][j][3] = 0.0f;
    const bf16* kb = kt + (lane % 8 + (lane / 16) * 8) * DkP + ((lane / 8) % 2) * 8;
    for (int kk = 0; kk < DkR; kk += 16 * KSETS) {
#pragma unroll
      for (int e = 0; e < KSETS; ++e) {
        const int k = kk + 16 * e;
        if (k >= DkR) continue;
        uint32_t a[4];
        ldsm_x4(a, qa + k);
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t bb[4];
          if (j + 1 < ns) {
            ldsm_x4(bb, kb + j * 8 * DkP + k);
            mma_bf16(sk[e][j], a, bb[0], bb[1]);
            mma_bf16(sk[e][j + 1], a, bb[2], bb[3]);
          } else if (j < ns) {
            ldsm_x2(bb, kb + j * 8 * DkP + k);
            mma_bf16(sk[e][j], a, bb[0], bb[1]);
          }
        }
      }
    }
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) sc[j][x] = KSETS == 2 ? sk[0][j][x] + sk[KSETS - 1][j][x] : sk[0][j][x];
    page_softmax<NS, NVW>(sc, acc, ns, pos_s + page * sb.psp + sj * ps8, n, qp0, qp1, window,
                          scale, m0, m1, l0, l1);
    // acc += P V: V is the K tile's first Dv columns, this warp's share
    const bf16* vb = kt + (lane % 8 + ((lane / 8) % 2) * 8) * DkP + (lane / 16) * 8 + c0;
    page_pv<NS, NVW>(sc, acc, ns, vb, DkP, my_nvt);
  }
  cp_wait<0>();  // nothing in flight at exit (q's group when no page has a slot)

  // slot-less pages, for the rows that have seen no valid key: v is the
  // k rows' prefix
  if (sp.walk_all && nv < np) {  // uniform across the block
    sum_slotless<KT>(k_pages, k_scale, pid_s, valid, np, PS, Dv, Dk, 0, NT, vsum_s);
    if (active)
      add_slotless<NVW>(acc, vsum_s, c0, my_nvt, (float)((np - nv) * PS), m0, m1, l0, l1);
  }
  if (!active) return;

  const int rows[2] = {r0, r1};
  const float ls[2] = {l0, l1}, ms[2] = {m0, m1};
  float* w = ws + ((size_t)b * gridDim.y + blockIdx.y) * SG * (Dv + 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= nr) continue;
    const int r = r_lo + rows[h];
    store_row<NVW, false>(acc, h, ms[h], ls[h], my_nvt, c0, gridDim.y == 1,
                   out + ((size_t)b * SG + r) * Dv, w, r, SG, Dv, warp % LT_WARPS == 0 && tig == 0);
  }
}

size_t tc_smem_bytes(int S, int G, int Dk, int Dv, int PS, int pps, int kv_int8, int latent) {
  const int rows16 = latent ? LT_MTILES * 16
                            : ((S < s_block(G) ? S : s_block(G)) * G + 15) / 16 * 16;
  return tc_layout(rows16, Dk, Dv, PS, pps, kv_int8 != 0, latent != 0).total;
}

bool tc_shape_ok(int G, int Dk, int Dv, int PS, int pps, int latent) {
  const bool common = Dk > 0 && Dk <= 1024 && Dv > 0 && Dv % 8 == 0 && PS > 0 &&
                      pps <= TC_MAX_PPS;
  if (latent) return common && Dk % 8 == 0 && Dv <= LT_MAX_DV && Dv <= Dk;
  return common && Dk % 16 == 0 && Dv <= 128 && G <= ROWS;
}

// the kernel's dynamic shared memory, granted before its launch
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// merge the splits' partials unless one split wrote the output itself
cudaError_t combine_tc(const float* ws, void* out, int B, int S, int H, int KV, int Dv,
                       int nsplit, bool all_acc, cudaStream_t stream) {
  if (nsplit == 1) return cudaSuccess;
  return combine<bf16>(ws, out, B, S, H, KV, Dv, nsplit, all_acc, stream);
}

template <typename KT, int NVT, int NS, bool SUB>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int32_t* pos, const int32_t* tables,
                      const int32_t* qpos, float* ws, void* out, int B, int S, int H, int KV,
                      int Dk, int Dv, int PS, int P, int pps, int window, float scale,
                      cudaStream_t stream) {
  const int G = H / KV;
  auto kernel = paged_attn_tc_kernel<KT, NVT, NS, SUB>;
  const size_t smem = tc_smem_bytes(S, G, Dk, Dv, PS, pps, std::is_same<KT, int8_t>::value, 0);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nsplit = (P + pps - 1) / pps;
  const int s_blk = s_block(G);
  const int nrow = (S + s_blk - 1) / s_blk;
  kernel<<<dim3(B * KV, nsplit, nrow), THREADS, smem, stream>>>(
      (const bf16*)q, (const KT*)k, (const KT*)v, ks, vs, pos, tables, qpos, ws, (bf16*)out,
      S, H, KV, Dk, Dv, PS, P, pps, s_blk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine_tc(ws, out, B, S, H, KV, Dv, nsplit, true, stream);
}

// the GQA instance for Dv and PS: the accumulator covers Dv, the S
// fragment PS (registers sized for 16-slot pages unless the pages are
// larger)
template <typename KT, typename... A>
cudaError_t launch_tc_for(int Dv, int PS, A... args) {
  if (PS <= 16)
    return Dv <= 64 ? launch_tc<KT, 8, 2, false>(args...) : launch_tc<KT, 16, 2, false>(args...);
  if (PS <= TC_MAX_PS)
    return Dv <= 64 ? launch_tc<KT, 8, 8, false>(args...) : launch_tc<KT, 16, 8, false>(args...);
  return Dv <= 64 ? launch_tc<KT, 8, 8, true>(args...) : launch_tc<KT, 16, 8, true>(args...);
}

template <typename KT, int NS, bool SUB>
cudaError_t launch_latent_tc(const void* q, const void* k, const float* ks, const int32_t* pos,
                             const int32_t* tables, const int32_t* qpos, float* ws, void* out,
                             int B, int S, int H, int Dk, int Dv, int PS, int P, int pps,
                             int window, float scale, cudaStream_t stream) {
  auto kernel = paged_attn_latent_tc_kernel<KT, NS, SUB>;
  const size_t smem = tc_smem_bytes(S, H, Dk, Dv, PS, pps, std::is_same<KT, int8_t>::value, 1);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nsplit = (P + pps - 1) / pps;
  const int rt = LT_MTILES * 16;
  kernel<<<dim3(B, nsplit, (S * H + rt - 1) / rt), LT_THREADS, smem, stream>>>(
      (const bf16*)q, (const KT*)k, ks, pos, tables, qpos, ws, (bf16*)out, S, H, Dk, Dv, PS, P,
      pps, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine_tc(ws, out, B, S, H, 1, Dv, nsplit, false, stream);
}

}  // namespace

// Dynamic shared memory the scalar kernel needs for these shapes: at most
// ROWS query rows per block (the wrapper refuses shapes above 227 KB).
extern "C" size_t paged_attn_smem_bytes(int S, int G, int Dk, int Dv, int PS, int latent) {
  return smem_bytes(S, G, Dk, Dv, PS, latent);
}

// A tensor-core kernel's dynamic shared memory for these shapes (GQA, or
// latent != 0), or 0 for a shape it does not take (see paged_attn).
extern "C" size_t paged_attn_tc_smem_bytes(int S, int G, int Dk, int Dv, int PS,
                                           int pages_per_split, int kv_int8, int latent) {
  if (!tc_shape_ok(G, Dk, Dv, PS, pages_per_split, latent)) return 0;
  return tc_smem_bytes(S, G, Dk, Dv, PS, pages_per_split, kv_int8, latent);
}

// C entry point, bound with ctypes (kernels/paged_attn.py).  kv_int8
// selects int8 pages with k_scale/v_scale planes (latent: k_scale only);
// c_bf16 selects bf16 (else f32) for q, native pages and the output.
// window <= 0 means no sliding window.  latent != 0 is MLA's latent mode:
// KV == 1, Dv <= Dk, v_pages and v_scale unread (may be NULL).
// bf16 calls run the tensor-core kernels, which take Dv % 8 == 0, any
// PS >= 1, pages_per_split <= 32 and 16-byte aligned q and pages; GQA
// also Dk % 16 == 0, Dv <= 128 and G = H / KV <= 64, latent Dk % 8 == 0
// and Dv <= 256.
// Other bf16 shapes return cudaErrorInvalidValue.  f32 calls run the
// scalar kernel.  ws is f32 scratch of B*KV*ceil(P/pages_per_split)*S*G*(Dv+2)
// floats for the splits' partial statistics (NULL is allowed for a
// tensor-core call with one split).  Returns cudaGetLastError().
extern "C" int paged_attn(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scale, const void* v_scale, const void* pos_tbl,
                          const void* page_tables, const void* q_pos, void* ws, void* out,
                          int B, int S, int H, int KV, int Dk, int Dv, int PS, int P,
                          int pages_per_split, int window, int latent, float scale,
                          int kv_int8, int c_bf16, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || PS <= 0 || P <= 0 ||
      pages_per_split <= 0 || (latent && (KV != 1 || Dv <= 0 || Dv > Dk)))
    return (int)cudaErrorInvalidValue;
  float* w = (float*)ws;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int32_t* pos = (const int32_t*)pos_tbl;
  const int32_t* tab = (const int32_t*)page_tables;
  const int32_t* qp = (const int32_t*)q_pos;
  if (c_bf16) {
    if (!tc_shape_ok(H / KV, Dk, Dv, PS, pages_per_split, latent))
      return (int)cudaErrorInvalidValue;
    if (latent) {
#define LT_ARGS(KS) q, k_pages, KS, pos, tab, qp, w, out, B, S, H, Dk, Dv, PS, P, \
      pages_per_split, window, scale, st
      cudaError_t err;
      if (kv_int8)
        err = PS <= 16        ? launch_latent_tc<int8_t, 2, false>(LT_ARGS(ks))
              : PS <= TC_MAX_PS ? launch_latent_tc<int8_t, 8, false>(LT_ARGS(ks))
                                : launch_latent_tc<int8_t, 8, true>(LT_ARGS(ks));
      else
        err = PS <= 16        ? launch_latent_tc<bf16, 2, false>(LT_ARGS(nullptr))
              : PS <= TC_MAX_PS ? launch_latent_tc<bf16, 8, false>(LT_ARGS(nullptr))
                                : launch_latent_tc<bf16, 8, true>(LT_ARGS(nullptr));
#undef LT_ARGS
      return (int)err;
    }
#define TC_ARGS(KS, VS)                                                          \
  q, k_pages, v_pages, KS, VS, pos, tab, qp, w, out, B, S, H, KV, Dk, Dv, PS, P, \
      pages_per_split, window, scale, st
    const cudaError_t err = kv_int8 ? launch_tc_for<int8_t>(Dv, PS, TC_ARGS(ks, vs))
                                    : launch_tc_for<bf16>(Dv, PS, TC_ARGS(nullptr, nullptr));
#undef TC_ARGS
    return (int)err;
  }
#define PA_ARGS(KS, VS)                                                            \
  q, k_pages, v_pages, KS, VS, pos, tab, qp, w, out, B, S, H, KV, Dk, Dv, PS, P,   \
      pages_per_split, window, latent, scale, st
  const cudaError_t err = kv_int8 ? launch<int8_t, float>(PA_ARGS(ks, vs))
                                  : launch<float, float>(PA_ARGS(nullptr, nullptr));
#undef PA_ARGS
  return (int)err;
}
