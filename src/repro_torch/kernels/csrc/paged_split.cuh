// Split-KV attention of a short block of query rows over a paged KV pool
// on the CUDA cores: the two passes shared by the fp32-q forms, on fp32
// and on int8 pools, of B6 (paged decode, csrc/paged_decode_attention.cu)
// and B7 (paged verify, csrc/paged_verify_attention.cu).
//
// For each (sequence b, kv head h), R query rows (q is (B, Hkv, R, E))
// attend to the first kv_lens[b] logical rows of the sequence, gathered
// from the pool (Hkv, P, page_size, E) through its row of the page table
// (B, max_pages). Row i sits at absolute position q0 + i / rows_per_pos
// and sees the keys at positions <= min(that position, kv_len - 1):
//
// * decode (B6): q_starts is null, R = G query heads, and every row sees
//   the whole live context (the kernel is instantiated without the
//   position mask, VERIFY = false);
// * verify (B7): q0 = q_starts[b]; the rows are position-major, row i is
//   query head i % G of speculative position i / G (rows_per_pos = G).
//   Rows past kv_len (slots verifying fewer than k rows) see the whole
//   live context, with no special case, and the host drops them.
//
// Pass 1 cuts the logical rows into 64-row tiles and the tiles over
// gridDim.x blocks per (b, h) (the split is planned over the table's
// capacity, so no host sync is needed); each block walks its tiles with an
// online max/sum, in three bands: tiles wholly below min(q0 + 1, kv_len)
// run unmasked, later live tiles take the fused select
// `col <= q0 + i / rows_per_pos && col < kv_len`, and tiles at or past
// kv_len are dead and never loaded. Pass 2 (split_combine_kernel) merges
// the partial (m, l, acc); kv_len 0 gives zeros.
//
// int8 pools (KV = int8_t) carry per-page fp32 scales (Hkv, P). Rows are
// loaded as 16-byte vectors, several of a thread in flight at once, and
// converted to fp32 in registers while they are staged; the scale of each
// tile column is looked up through the page table (a 64-row tile spans
// several pages), the K scale multiplies the score column after q.k and
// sm_scale, the V scale folds into P (the row sum takes P unscaled)
// before the P.V product, as the TPU kernels do.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int PAGED_THREADS = 128;
constexpr int PAGED_MAXE_PT = 2;   // output columns per thread: E <= 256

__host__ __device__ __forceinline__ int paged_stat_floats(int R) {
  return (3 * R + 3) / 4 * 4;
}

template <typename T, typename KV, int MAXR, bool VERIFY>
__global__ void __launch_bounds__(PAGED_THREADS)
paged_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ table,
                   const int* __restrict__ kv_lens,
                   const int* __restrict__ q_starts,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int Hkv, int R,
                   int rows_per_pos, int n_pages, int page_size,
                   int max_pages, int E, int tiles_per_split,
                   float sm_scale) {
  using S = typename TileOf<T, KV>::type;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  // int8 loads a thread keeps in flight for K and for V (stage_q8_kv):
  // at 4 the 32-row verify instantiation needs far more registers and
  // ran slower than at 2 on an H100; decode gains from 4.
  constexpr int Q8_BATCH = MAXR > 16 ? 2 : 4;
  const int sp = blockIdx.x, bh = blockIdx.y, n_split = gridDim.x;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int t = threadIdx.x;
  const int kv_len = min(kv_lens[b], max_pages * page_size);
  // decode: every row sees the live context, only the kv tail is masked
  const int q0 = VERIFY ? q_starts[b] : kv_len - 1;
  const int n_full = VERIFY ? max(0, min(q0 + 1, kv_len)) / KV_TILE : 0;
  const int* row_table = table + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * n_pages * page_size * E;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);          // (R, E)
  float* Ps = Qs + R * E;                              // (R, KV_TILE)
  float* M = Ps + R * KV_TILE;
  float* Lsum = M + R;
  float* A = Lsum + R;
  // The m/l/alpha rows are padded to 16 bytes so the tiles stay aligned.
  // int8 only: the tile's K and V scales (KV_TILE each)
  float* KS = M + paged_stat_floats(R);
  float* VS = KS + KV_TILE;
  S* Kt = reinterpret_cast<S*>(KS + scale_floats<KV>());  // (KV_TILE, E + pad)
  S* Vt = Kt + KV_TILE * (E + KV_ROW_PAD);

  stage_q(Qs, q + (size_t)bh * R * E, R, E);
  for (int r = t; r < R; r += PAGED_THREADS) {
    M[r] = NEG_INF;
    Lsum[r] = 0.f;
  }
  // S tile: column c, query rows gg, gg + 2, ...
  const int c = t % KV_TILE, gg = t / KV_TILE;
  const int nr = R > gg ? (R - gg + 1) / 2 : 0;
  float acc[MAXR][PAGED_MAXE_PT];
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
#pragma unroll
    for (int x = 0; x < PAGED_MAXE_PT; ++x) acc[r][x] = 0.f;

  const int j0 = sp * tiles_per_split;
  const int j1 = j0 + tiles_per_split;
  for (int j = j0; j < j1; ++j) {
    const int col0 = j * KV_TILE;
    if (col0 >= kv_len) break;  // dead pages: no load, no compute
    const int rows = min(KV_TILE, kv_len - col0);
    __syncthreads();
    if constexpr (Q8) {
      stage_q8_kv<Q8_BATCH>(Kt, Vt, k + head_off, v + head_off,
                            PagedRows{row_table, page_size, col0, E}, rows,
                            KV_TILE, E);
      stage_page_scales(KS, VS, ks + (size_t)h * n_pages,
                        vs + (size_t)h * n_pages, row_table, page_size, col0,
                        rows);
    } else {
      stage_paged_rows(Kt, k + head_off, row_table, page_size, col0, rows,
                       KV_TILE, E);
      stage_paged_rows(Vt, v + head_off, row_table, page_size, col0, rows,
                       KV_TILE, E);
    }
    __syncthreads();

    const bool need_mask = j >= n_full;
    const int col = col0 + c;
    float s_acc[MAXR / 2];
    qk_dots<MAXR / 2>(s_acc, Qs, Kt + c * (E + KV_ROW_PAD), E, nr, gg, 2);
#pragma unroll
    for (int i = 0; i < MAXR / 2; ++i) {
      if (i < nr) {
        const int r = gg + 2 * i;
        float s = s_acc[i] * sm_scale;
        if (Q8) s *= KS[c];
        if (col >= kv_len ||
            (VERIFY && need_mask && col > q0 + r / rows_per_pos))
          s = NEG_INF;
        Ps[r * KV_TILE + c] = s;
      }
    }
    __syncthreads();
    {
      const int warp = t / 32, lane = t % 32;
      for (int r = warp; r < R; r += PAGED_THREADS / 32) {
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
    // P V: thread t owns output columns t and t + PAGED_THREADS.
#pragma unroll
    for (int x = 0; x < PAGED_MAXE_PT; ++x) {
      const int e = t + x * PAGED_THREADS;
      if (e < E) {
        float part[MAXR];
#pragma unroll
        for (int r = 0; r < MAXR; ++r) part[r] = 0.f;
        for (int jj = 0; jj < KV_TILE; ++jj) {
          const float vv = to_float(Vt[jj * (E + KV_ROW_PAD) + e]);
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            if (r < R) part[r] = fmaf(Ps[r * KV_TILE + jj], vv, part[r]);
        }
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < R) acc[r][x] = acc[r][x] * A[r] + part[r];
      }
    }
  }
  __syncthreads();

  const size_t part_row = ((size_t)bh * n_split + sp) * R;
  for (int r = t; r < R; r += PAGED_THREADS) {
    m_part[part_row + r] = M[r];
    l_part[part_row + r] = Lsum[r];
  }
#pragma unroll
  for (int x = 0; x < PAGED_MAXE_PT; ++x) {
    const int e = t + x * PAGED_THREADS;
    if (e < E) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < R) acc_part[(part_row + r) * E + e] = acc[r][x];
    }
  }
}

// Both passes on `stream`. KV is T, or int8_t with ks/vs the (Hkv, P)
// per-page scales. Returns the first CUDA error, or 0.
template <typename T, typename KV, int MAXR, bool VERIFY>
int paged_split_launch(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* table,
                       const void* kv_lens, const void* q_starts, void* o,
                       void* m_part, void* l_part, void* acc_part, int B,
                       int Hkv, int R, int rows_per_pos, int n_pages,
                       int page_size, int max_pages, int E, int n_split,
                       int tiles_per_split, float sm_scale,
                       cudaStream_t stream) {
  using S = typename TileOf<T, KV>::type;
  const size_t smem = 4ull * R * E + 4ull * R * KV_TILE +
                      4ull * paged_stat_floats(R) + 4ull * scale_floats<KV>() +
                      2ull * KV_TILE * (E + KV_ROW_PAD) * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, KV, MAXR, VERIFY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  paged_split_kernel<T, KV, MAXR, VERIFY>
      <<<dim3(n_split, B * Hkv), PAGED_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const int*>(kv_lens), static_cast<const int*>(q_starts),
          mp, lp, ap, Hkv, R, rows_per_pos, n_pages, page_size, max_pages, E,
          tiles_per_split, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_combine_kernel<T><<<B * Hkv, PAGED_THREADS, 0, stream>>>(
      mp, lp, ap, static_cast<T*>(o), R, E, n_split);
  return (int)cudaGetLastError();
}

}  // namespace repro
