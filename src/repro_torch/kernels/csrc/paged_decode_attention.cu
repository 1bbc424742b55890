// Split-KV one-token decode over a paged KV pool for Hopper: kernel B6.
//
// Replaces the Pallas kernel repro/kernels/paged_decode_attention.py
// (paged_decode_attention_flat; body _paged_decode_kernel), bf16/fp32
// pool branch. The int8 branch (k_scales / v_scales) is not ported yet.
//
// What it computes: for each (sequence b, kv head h) the G query heads of
// its GQA group attend to the first kv_lens[b] logical rows of the
// sequence, gathered from the pool (Hkv, P, page_size, E) through its row
// of the page table (B, max_pages). Both the table and kv_lens are device
// arrays the kernel reads itself, so a decode step needs no host sync.
// Pass 1 splits the logical rows into 64-row tiles and the tiles over
// gridDim.x blocks per (b, h); each block walks its tiles with an online
// max/sum, stopping at the first tile at or past kv_len (no load), and
// writes a partial (m, l, acc). Pass 2 (split_combine_kernel) merges the
// partials; a sequence with kv_len 0 gets zeros (l == 0 divides by 1).
//
// What bounds it on an H100: one query row per head reads every live K
// and V row once, about one multiply-add per byte, so its floor is
// device-memory bandwidth over the live rows only. B * Hkv blocks alone
// (64 at batch 8) would leave most of the 132 SMs idle, so the live range
// is split over more blocks and merged in a second pass, as in B4. A tile
// is gathered row by row through the page table (each row's page looked
// up once, 8- or 16-byte reads along the row), staged once in shared
// memory and read there by all G query rows. Like B4, this first version
// stages a tile with one load after another per thread and no second tile
// in flight, so load latency, not bandwidth, sets its time.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;
constexpr int MAXG = 16;      // query heads per kv head
constexpr int MAXE_PT = 2;    // output columns per thread: E <= 256

__host__ __device__ __forceinline__ int stat_floats(int G) {
  return (3 * G + 3) / 4 * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ table,
                          const int* __restrict__ kv_lens,
                          float* __restrict__ m_part,
                          float* __restrict__ l_part,
                          float* __restrict__ acc_part, int Hkv, int G,
                          int n_pages, int page_size, int max_pages, int E,
                          int tiles_per_split, float sm_scale) {
  const int sp = blockIdx.x, bh = blockIdx.y, n_split = gridDim.x;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int t = threadIdx.x;
  const int kv_len = min(kv_lens[b], max_pages * page_size);
  const int* row_table = table + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * n_pages * page_size * E;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);          // (G, E)
  float* Ps = Qs + G * E;                              // (G, KV_TILE)
  float* M = Ps + G * KV_TILE;
  float* Lsum = M + G;
  float* A = Lsum + G;
  // The m/l/alpha rows are padded to 16 bytes so the tiles stay aligned.
  T* Kt = reinterpret_cast<T*>(M + stat_floats(G));    // (KV_TILE, E + pad)
  T* Vt = Kt + KV_TILE * (E + KV_ROW_PAD);

  stage_q(Qs, q + (size_t)bh * G * E, G, E);
  for (int g = t; g < G; g += THREADS) {
    M[g] = NEG_INF;
    Lsum[g] = 0.f;
  }
  // S tile: column c, query rows gg, gg + 2, ...
  const int c = t % KV_TILE, gg = t / KV_TILE;
  const int nr = G > gg ? (G - gg + 1) / 2 : 0;
  float acc[MAXG][MAXE_PT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int x = 0; x < MAXE_PT; ++x) acc[g][x] = 0.f;

  const int j0 = sp * tiles_per_split;
  const int j1 = j0 + tiles_per_split;
  for (int j = j0; j < j1; ++j) {
    const int col0 = j * KV_TILE;
    if (col0 >= kv_len) break;  // dead pages: no load, no compute
    const int rows = min(KV_TILE, kv_len - col0);
    __syncthreads();
    stage_paged_rows(Kt, k + head_off, row_table, page_size, col0, rows,
                     KV_TILE, E);
    stage_paged_rows(Vt, v + head_off, row_table, page_size, col0, rows,
                     KV_TILE, E);
    __syncthreads();

    float s_acc[MAXG / 2];
    qk_dots<MAXG / 2>(s_acc, Qs, Kt + c * (E + KV_ROW_PAD), E, nr, gg, 2);
#pragma unroll
    for (int i = 0; i < MAXG / 2; ++i) {
      if (i < nr) {
        float s = s_acc[i] * sm_scale;
        if (col0 + c >= kv_len) s = NEG_INF;   // kv tail
        Ps[(gg + 2 * i) * KV_TILE + c] = s;
      }
    }
    __syncthreads();
    {
      const int warp = t / 32, lane = t % 32;
      for (int g = warp; g < G; g += THREADS / 32) {
        float* row = Ps + g * KV_TILE;
        const float s0 = row[lane], s1 = row[lane + 32];
        const float m_prev = M[g];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        row[lane] = p0;
        row[lane + 32] = p1;
        const float psum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          Lsum[g] = Lsum[g] * alpha + psum;
          A[g] = alpha;
          M[g] = m_new;
        }
      }
    }
    __syncthreads();
    // P V: thread t owns output columns t and t + THREADS.
#pragma unroll
    for (int x = 0; x < MAXE_PT; ++x) {
      const int e = t + x * THREADS;
      if (e < E) {
        float part[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
        for (int jj = 0; jj < KV_TILE; ++jj) {
          const float vv = to_float(Vt[jj * (E + KV_ROW_PAD) + e]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) part[g] = fmaf(Ps[g * KV_TILE + jj], vv, part[g]);
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g][x] = acc[g][x] * A[g] + part[g];
      }
    }
  }
  __syncthreads();

  const size_t part_row = ((size_t)bh * n_split + sp) * G;
  for (int g = t; g < G; g += THREADS) {
    m_part[part_row + g] = M[g];
    l_part[part_row + g] = Lsum[g];
  }
#pragma unroll
  for (int x = 0; x < MAXE_PT; ++x) {
    const int e = t + x * THREADS;
    if (e < E) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc_part[(part_row + g) * E + e] = acc[g][x];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* kv_lens, void* o, float* m_part, float* l_part,
           float* acc_part, int B, int Hkv, int G, int n_pages,
           int page_size, int max_pages, int E, int n_split,
           int tiles_per_split, float sm_scale, cudaStream_t stream) {
  const size_t smem = 4ull * G * E + 4ull * G * KV_TILE + 4ull * stat_floats(G) +
                      2ull * KV_TILE * (E + KV_ROW_PAD) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_split_kernel<T><<<dim3(n_split, B * Hkv), THREADS, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, kv_lens, m_part, l_part, acc_part, Hkv,
      G, n_pages, page_size, max_pages, E, tiles_per_split, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_combine_kernel<T><<<B * Hkv, THREADS, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), G, E, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hkv, G, E); k, v: (Hkv, n_pages, page_size, E); table:
// (B, max_pages) int32 and kv_lens: (B,) int32 on the device; o: like q.
// Scratch: m_part, l_part (B * Hkv, n_split, G) and acc_part
// (B * Hkv, n_split, G, E), fp32. Split sp covers the 64-row tiles
// [sp * tiles_per_split, (sp + 1) * tiles_per_split) of the logical rows.
// Contiguous.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* kv_lens, void* o, void* m_part, void* l_part, void* acc_part,
    int B, int Hkv, int G, int n_pages, int page_size, int max_pages, int E,
    int n_split, int tiles_per_split, float sm_scale, int dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(kv_lens);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (dtype == 0)
    return launch<float>(q, k, v, tab, lens, o, mp, lp, ap, B, Hkv, G,
                         n_pages, page_size, max_pages, E, n_split,
                         tiles_per_split, sm_scale, s);
  return launch<__nv_bfloat16>(q, k, v, tab, lens, o, mp, lp, ap, B, Hkv, G,
                               n_pages, page_size, max_pages, E, n_split,
                               tiles_per_split, sm_scale, s);
}
