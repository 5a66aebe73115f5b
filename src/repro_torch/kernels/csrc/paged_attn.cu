// Fused paged attention for Hopper (sm_90a): GQA mode and MLA's latent mode.
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
// What bounds it on the H100.  Every query row reads the whole cached
// window of its request once, and at serving shapes (S * G <= 64 rows per
// KV head, head_dim 128) that is about 2 * S * G operations per KV byte:
// far below the card's operations-per-byte balance, so the bound is the
// bytes of the int8 pages, scales and slot positions (3.35 TB/s).
//
// What the design does about it.  The dense window is never materialized:
// a block loads each page of its share once into shared memory and serves
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
// Still simple: scalar FMAs instead of tensor cores and no cp.async
// double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// e_j = exp(m_j - max_j m_j).
template <typename CT>
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
  float m = NEG_INF;
  for (int j = 0; j < nsplit; ++j) m = fmaxf(m, base[j * stride + SG * Dv + r]);
  float l = 0.0f, acc = 0.0f;
  for (int j = 0; j < nsplit; ++j) {
    const float* w = base + j * stride;
    const float e = expf(w[SG * Dv + r] - m);
    l += e * w[SG * Dv + SG + r];
    acc += e * w[r * Dv + d];
  }
  store(out + (((size_t)b * S + s) * H + kvh * G + g) * Dv + d, acc / fmaxf(l, 1e-30f));
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
  const size_t total = (size_t)B * KV * S * (H / KV) * Dv;
  paged_attn_combine<CT><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      ws, (CT*)out, B, S, H, KV, Dv, nsplit);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for these shapes: at most ROWS
// query rows per block (the wrapper refuses shapes above 227 KB).
extern "C" size_t paged_attn_smem_bytes(int S, int G, int Dk, int Dv, int PS, int latent) {
  return smem_bytes(S, G, Dk, Dv, PS, latent);
}

// C entry point, bound with ctypes (kernels/paged_attn.py).  kv_int8
// selects int8 pages with k_scale/v_scale planes (latent: k_scale only);
// c_bf16 selects bf16 (else f32) for q, native pages and the output.
// window <= 0 means no sliding window.  latent != 0 is MLA's latent mode:
// KV == 1, Dv <= Dk, v_pages and v_scale unread (may be NULL).  ws is f32 scratch of B*KV*ceil(P/pages_per_split)*S*G*(Dv+2)
// floats for the splits' partial statistics.  Returns cudaGetLastError().
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
#define PA_ARGS(KS, VS)                                                            \
  q, k_pages, v_pages, KS, VS, pos, tab, qp, w, out, B, S, H, KV, Dk, Dv, PS, P,   \
      pages_per_split, window, latent, scale, st
  cudaError_t err;
  if (kv_int8) {
    err = c_bf16 ? launch<int8_t, __nv_bfloat16>(PA_ARGS(ks, vs))
                 : launch<int8_t, float>(PA_ARGS(ks, vs));
  } else {
    err = c_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(PA_ARGS(nullptr, nullptr))
                 : launch<float, float>(PA_ARGS(nullptr, nullptr));
  }
#undef PA_ARGS
  return (int)err;
}
