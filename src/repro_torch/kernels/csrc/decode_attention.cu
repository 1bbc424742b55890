// Split-KV one-token decode attention for Hopper: kernel B4.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py
// (decode_attention_flat; body _decode_kernel), both its bf16/fp32 cache
// branch and its int8 branch with one fp32 scale per cache row.
//
// What it computes: for each (b, kv head) the G query heads of its GQA
// group attend to the dense cache rows [0, kv_len), kv_len read from a
// device array (one value per (b, kv head), so a batch may be ragged).
// Pass 1 splits the live KV range over gridDim.x blocks; each walks its
// KV tiles with an online max/sum exactly as the TPU kernel walks its
// grid, skipping tiles at or past kv_len (no load), and writes a partial
// (m, l, acc). Pass 2 merges the partials: M = max m, L = sum l e^(m-M),
// O = sum acc e^(m-M) / L, with L == 0 guarded as in the TPU kernel.
// An int8 cache is read as 16-byte vectors, four K and four V loads of a
// thread in flight at once, and converted to fp32 in registers while a
// tile is staged; the row's K scale multiplies its
// score column after q.k and sm_scale, its V scale folds into P after the
// row sum and before the P.V product, in the TPU kernel's order.
//
// What bounds it on an H100: one query row per head reads every live K
// and V row once, about one multiply-add per byte, so its floor is
// device-memory bandwidth. The split across blocks puts more blocks in
// flight than B * Hkv alone (far below the 132 SMs), rows past kv_len are
// never loaded, and each K/V tile is loaded once per block with 8- or
// 16-byte coalesced reads and used by all G query rows from shared
// memory. This first version stages a tile with one load after another
// per thread and no second tile in flight, so load latency, not
// bandwidth, sets its time; double-buffered staging is later work. An
// int8 cache halves the bytes of a bf16 one (plus one 4-byte scale a K or
// V row); its staging issues its loads before it converts any, so a tile
// waits on fewer round trips to memory than a bf16 tile does.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;
constexpr int MAXG = 16;      // query heads per kv head
constexpr int MAXE_PT = 2;    // output columns per thread: E <= 256

__host__ __device__ __forceinline__ int stat_floats(int G) {
  return (3 * G + 3) / 4 * 4;
}

template <typename T, typename KV>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ kv_lens,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int G, int s_len, int E,
                    int tiles_per_split, float sm_scale) {
  using S = typename TileOf<T, KV>::type;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  const int sp = blockIdx.x, bh = blockIdx.y, n_split = gridDim.x;
  const int t = threadIdx.x;
  const int kv_len = min(kv_lens[bh], s_len);

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);          // (G, E)
  float* Ps = Qs + G * E;                              // (G, KV_TILE)
  float* M = Ps + G * KV_TILE;
  float* Lsum = M + G;
  float* A = Lsum + G;
  // The m/l/alpha rows are padded to 16 bytes so the tiles stay aligned.
  // int8 only: the tile's K and V scales (KV_TILE each)
  float* KS = M + stat_floats(G);
  float* VS = KS + KV_TILE;
  S* Kt = reinterpret_cast<S*>(KS + scale_floats<KV>());  // (KV_TILE, E + pad)
  S* Vt = Kt + KV_TILE * (E + KV_ROW_PAD);

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

  const size_t kv_off = (size_t)bh * s_len * E;
  const int j0 = sp * tiles_per_split;
  const int j1 = j0 + tiles_per_split;
  for (int j = j0; j < j1; ++j) {
    const int col0 = j * KV_TILE;
    if (col0 >= kv_len) break;  // dead tiles: no load, no compute
    const int rows = min(KV_TILE, kv_len - col0);
    __syncthreads();
    if constexpr (Q8) {
      stage_q8_kv<4>(Kt, Vt, k + kv_off + (size_t)col0 * E,
                     v + kv_off + (size_t)col0 * E, DenseRows{E}, rows,
                     KV_TILE, E);
      const size_t s0 = (size_t)bh * s_len + col0;
      for (int i = t; i < KV_TILE; i += THREADS) {
        KS[i] = i < rows ? ks[s0 + i] : 0.f;
        VS[i] = i < rows ? vs[s0 + i] : 0.f;
      }
    } else {
      stage_rows(Kt, k + kv_off + (size_t)col0 * E, rows, KV_TILE, E);
      stage_rows(Vt, v + kv_off + (size_t)col0 * E, rows, KV_TILE, E);
    }
    __syncthreads();

    float s_acc[MAXG / 2];
    qk_dots<MAXG / 2>(s_acc, Qs, Kt + c * (E + KV_ROW_PAD), E, nr, gg, 2);
#pragma unroll
    for (int i = 0; i < MAXG / 2; ++i) {
      if (i < nr) {
        float s = s_acc[i] * sm_scale;
        if (Q8) s *= KS[c];
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
        // the V scales fold into P; the row sum takes P unscaled
        row[lane] = Q8 ? p0 * VS[lane] : p0;
        row[lane + 32] = Q8 ? p1 * VS[lane + 32] : p1;
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

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* kv_lens, void* o, float* m_part,
           float* l_part, float* acc_part, int bh, int G, int s_len, int E,
           int n_split, int tiles_per_split, float sm_scale,
           cudaStream_t stream) {
  using S = typename TileOf<T, KV>::type;
  const size_t smem = 4ull * G * E + 4ull * G * KV_TILE + 4ull * stat_floats(G) +
                      4ull * scale_floats<KV>() +
                      2ull * KV_TILE * (E + KV_ROW_PAD) * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T, KV><<<dim3(n_split, bh), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), kv_lens, m_part, l_part, acc_part, G,
      s_len, E, tiles_per_split, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_combine_kernel<T><<<bh, THREADS, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), G, E, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, G, E); k, v: (bh, s_len, E) of q's type, or int8 when
// `quantized` with ks, vs the (bh, s_len) fp32 per-row scales; kv_lens:
// (bh,) int32 on the device; o: (bh, G, E). Scratch: m_part, l_part (bh, n_split, G) and acc_part
// (bh, n_split, G, E), fp32. Split sp covers KV tiles
// [sp * tiles_per_split, (sp + 1) * tiles_per_split). Contiguous.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* kv_lens,
                                       void* o, void* m_part, void* l_part,
                                       void* acc_part, int bh, int G,
                                       int s_len, int E, int n_split,
                                       int tiles_per_split, float sm_scale,
                                       int dtype, int quantized,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
#define REPRO_DECODE_ARGS                                                 \
  q, k, v, ks, vs, lens, o, mp, lp, ap, bh, G, s_len, E, n_split,         \
      tiles_per_split, sm_scale, s
  if (dtype == 0)
    return quantized ? launch<float, int8_t>(REPRO_DECODE_ARGS)
                     : launch<float, float>(REPRO_DECODE_ARGS);
  return quantized ? launch<__nv_bfloat16, int8_t>(REPRO_DECODE_ARGS)
                   : launch<__nv_bfloat16, __nv_bfloat16>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
}
