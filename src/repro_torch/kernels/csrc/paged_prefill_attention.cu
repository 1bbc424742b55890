// Chunked prefill attention over a paged KV pool for Hopper: kernel B5.
//
// Replaces the Pallas kernel repro/kernels/paged_prefill_attention.py
// (paged_prefill_attention_flat; body _paged_prefill_kernel), both its
// bf16/fp32 pool branch and its int8 branch with per-page scales.
//
// What it computes: one sequence's prompt chunk, q (Hq, chunk, E) with row
// i at absolute position q_offset + i, attends causally to the first
// kv_len logical rows of the sequence (all earlier context and the
// chunk's own rows, written into their pages just before the launch),
// gathered from the pool (Hkv, P, page_size, E) through the sequence's
// page table. Query head hq reads kv head hq / group. Row i sees the keys
// at positions <= min(q_offset + i, kv_len - 1); pad rows at or past
// kv_len see every live key and are dropped by the caller.
//
// The TPU kernel keeps a whole (chunk, E) fp32 accumulator per head on
// chip; at chunk 512 that is 256 KB, past the 227 KB a block may hold. So
// one thread block owns one (query head, block of blk_q rows) and walks
// 64-row tiles of logical kv rows with an online max/sum, in the
// three-band order of the TPU kernel: tiles wholly below the block's
// first row and below kv_len run with no mask; tiles that straddle the
// causal diagonal or the kv_len tail take the fused select
// cols <= rows && cols < kv_len; tiles past the block's last row or at or
// past kv_len are dead and never loaded. An int8 pool is read as 16-byte
// vectors, four K and four V loads of a thread in flight at once, and
// converted to fp32 in registers while a tile is staged; each
// tile column's per-page scales are looked up through the page table (a
// 64-row tile spans several pages), the K scale multiplies the score
// after q.k and sm_scale, the V scale folds into P after the row sum.
//
// What bounds it on an H100: like B3, the two products run on the CUDA
// cores in fp32 in this first version, so it is bound by instructions and
// load latency rather than by device memory: K and V tiles are gathered
// once per Q block and read from shared memory by all its rows, with no
// second tile in flight. Tensor cores and pipelined staging are later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int MAXR_S = 16;
constexpr int MAXR_PV = 8;

template <typename T, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ table, T* __restrict__ o,
                     int nq, int E, int group, int blk_q, int n_pages,
                     int page_size, int q_offset, int kv_len,
                     float sm_scale) {
  using S = typename TileOf<T, KV>::type;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  const int iq = blockIdx.x, hq = blockIdx.y;
  const int row0 = q_offset + iq * blk_q;   // position of the block's row 0
  const int t = threadIdx.x;
  // Tiles [0, n_full) need no mask; [n_full, n_live) take the select;
  // the rest are dead.
  const int last_col = min(row0 + blk_q - 1, kv_len - 1);
  const int n_live = last_col < 0 ? 0 : last_col / KV_TILE + 1;
  const int n_full = min(row0 + 1, kv_len) / KV_TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);          // (blk_q, KV_TILE)
  float* Qs = Ps + blk_q * KV_TILE;                    // (blk_q, E)
  float* M = Qs + blk_q * E;                           // running max
  float* Lsum = M + blk_q;                             // running sum
  float* A = Lsum + blk_q;                             // this tile's rescale
  float* KS = A + blk_q;              // int8 only: the tile's K, V scales
  float* VS = KS + KV_TILE;
  S* Kt = reinterpret_cast<S*>(KS + scale_floats<KV>());  // (KV_TILE, E + pad)
  S* Vt = Kt + KV_TILE * (E + KV_ROW_PAD);

  // Thread layout: S tile column c, rows rg_s + 4 i; output columns
  // ce..ce+3, rows rg_pv + rstep_pv i.
  const int c = t % KV_TILE, rg_s = t / KV_TILE;
  const int nr_s = blk_q > rg_s ? (blk_q - rg_s + 3) / 4 : 0;
  const int cpr = E / 4;
  const int ce = (t % cpr) * 4, rg_pv = t / cpr, rstep_pv = THREADS / cpr;
  const int nr_pv = blk_q > rg_pv ? (blk_q - rg_pv + rstep_pv - 1) / rstep_pv : 0;

  stage_q(Qs, q + ((size_t)hq * nq + iq * blk_q) * E, blk_q, E);
  for (int r = t; r < blk_q; r += THREADS) {
    M[r] = NEG_INF;
    Lsum[r] = 0.f;
  }
  float acc[MAXR_PV][4];
#pragma unroll
  for (int i = 0; i < MAXR_PV; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int hkv = hq / group;
  const KV* k_head = k + (size_t)hkv * n_pages * page_size * E;
  const KV* v_head = v + (size_t)hkv * n_pages * page_size * E;
  for (int j = 0; j < n_live; ++j) {
    const int col0 = j * KV_TILE;
    const int rows = min(KV_TILE, kv_len - col0);
    __syncthreads();
    if constexpr (Q8) {
      stage_q8_kv<4>(Kt, Vt, k_head, v_head,
                     PagedRows{table, page_size, col0, E}, rows, KV_TILE, E);
      stage_page_scales(KS, VS, ks + (size_t)hkv * n_pages,
                        vs + (size_t)hkv * n_pages, table, page_size, col0,
                        rows);
    } else {
      stage_paged_rows(Kt, k_head, table, page_size, col0, rows, KV_TILE, E);
      stage_paged_rows(Vt, v_head, table, page_size, col0, rows, KV_TILE, E);
    }
    __syncthreads();

    const bool need_mask = j >= n_full;
    float s_acc[MAXR_S];
    qk_dots<MAXR_S>(s_acc, Qs, Kt + c * (E + KV_ROW_PAD), E, nr_s, rg_s, 4);
    const int col = col0 + c;
#pragma unroll
    for (int i = 0; i < MAXR_S; ++i) {
      if (i < nr_s) {
        const int r = rg_s + 4 * i;
        float s = s_acc[i] * sm_scale;
        if (Q8) s *= KS[c];
        if (need_mask && !(col <= row0 + r && col < kv_len)) s = NEG_INF;
        Ps[r * KV_TILE + c] = s;
      }
    }
    __syncthreads();

    // Online max/sum, one warp per row; P overwrites S in place.
    {
      const int warp = t / 32, lane = t % 32;
      for (int r = warp; r < blk_q; r += THREADS / 32) {
        float* row = Ps + r * KV_TILE;
        const float s0 = row[lane], s1 = row[lane + 32];
        const float m_prev = M[r];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        // the V scales fold into P; the row sum takes P unscaled
        row[lane] = Q8 ? p0 * VS[lane] : p0;
        row[lane + 32] = Q8 ? p1 * VS[lane + 32] : p1;
        const float psum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          Lsum[r] = Lsum[r] * alpha + psum;
          A[r] = alpha;
          M[r] = m_new;
        }
      }
    }
    __syncthreads();

    float part[MAXR_PV][4];
    pv_sums<MAXR_PV>(part, Ps, KV_TILE, Vt, KV_TILE, E, ce, nr_pv, rg_pv,
                     rstep_pv);
#pragma unroll
    for (int i = 0; i < MAXR_PV; ++i) {
      if (i < nr_pv) {
        const float alpha = A[rg_pv + i * rstep_pv];
        acc[i][0] = acc[i][0] * alpha + part[i][0];
        acc[i][1] = acc[i][1] * alpha + part[i][1];
        acc[i][2] = acc[i][2] * alpha + part[i][2];
        acc[i][3] = acc[i][3] * alpha + part[i][3];
      }
    }
  }
  __syncthreads();

  T* ob = o + ((size_t)hq * nq + iq * blk_q) * E;
#pragma unroll
  for (int i = 0; i < MAXR_PV; ++i) {
    if (i < nr_pv) {
      const int r = rg_pv + i * rstep_pv;
      float l = Lsum[r];
      l = l == 0.f ? 1.f : l;  // rows that saw no key (kv_len == 0)
      T* dst = ob + (size_t)r * E + ce;
      store(dst + 0, acc[i][0] / l);
      store(dst + 1, acc[i][1] / l);
      store(dst + 2, acc[i][2] / l);
      store(dst + 3, acc[i][3] / l);
    }
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* table, void* o, int hq, int nq, int E,
           int group, int blk_q, int n_pages, int page_size, int q_offset,
           int kv_len, float sm_scale, cudaStream_t stream) {
  using S = typename TileOf<T, KV>::type;
  const size_t smem = 4ull * blk_q * KV_TILE + 4ull * blk_q * E +
                      3ull * 4 * blk_q + 4ull * scale_floats<KV>() +
                      2ull * KV_TILE * (E + KV_ROW_PAD) * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / blk_q, hq);
  paged_prefill_kernel<T, KV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), table, static_cast<T*>(o), nq, E, group,
      blk_q, n_pages, page_size, q_offset, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (hq, nq, E), nq % blk_q == 0; k, v: (hq / group, n_pages, page_size,
// E) of q's type, or int8 when `quantized` with ks, vs the
// (hq / group, n_pages) fp32 per-page scales; table: (max_pages,) int32 on the device, covering at least kv_len
// rows; o: like q. Contiguous.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, void* o, int hq, int nq, int E,
    int group, int blk_q, int n_pages, int page_size, int q_offset,
    int kv_len, float sm_scale, int dtype, int quantized, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
#define REPRO_PREFILL_ARGS                                                \
  q, k, v, ks, vs, tab, o, hq, nq, E, group, blk_q, n_pages, page_size,   \
      q_offset, kv_len, sm_scale, s
  if (dtype == 0)
    return quantized ? launch<float, int8_t>(REPRO_PREFILL_ARGS)
                     : launch<float, float>(REPRO_PREFILL_ARGS);
  return quantized ? launch<__nv_bfloat16, int8_t>(REPRO_PREFILL_ARGS)
                   : launch<__nv_bfloat16, __nv_bfloat16>(REPRO_PREFILL_ARGS);
#undef REPRO_PREFILL_ARGS
}
