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
// KV rows with an online max/sum exactly as the TPU kernel walks its
// grid, skipping rows at or past kv_len (no load), and writes a partial
// (m, l, acc). Pass 2 merges the partials: M = max m, L = sum l e^(m-M),
// O = sum acc e^(m-M) / L, with L == 0 guarded as in the TPU kernel.
//
// What bounds it on an H100: one query row per head reads every live K
// and V row once, about G/2 multiply-adds a byte, so its floor is
// device-memory bandwidth (an int8 cache halves the bytes). The forms,
// chosen by the caller by dtype (decode_attention.py's entry_point), none
// falling back to another:
// - a bf16 q on bf16 caches (decode_bf16_launch) and on int8 caches
//   (decode_int8_launch with a bf16 q): the tensor-core design of
//   decode_tc.cuh. Short splits (decode_split_plan: 1-4 tiles a block)
//   spread the longest sequence of a ragged batch over every SM; each warp
//   keeps a 3-slot cp.async ring of 16-row K/V slices of a (b, kv head)'s
//   contiguous rows in flight and its own online softmax, with no
//   __syncthreads a tile; S and P V are mma.sync products with the G query
//   rows padded to 16 and P as bf16 hi + lo. An int8 slice lands raw with
//   its 16 rows' K and V scales (contiguous in the (BH, S) scales) and
//   each lane converts the chunks it copied to bf16 (exact) into its
//   warp's slot; the K scale multiplies the score, the V scale P after
//   the row sum. The merge pass is decode_bf16_merge_kernel, for both.
//   Head dims 64 and 128, and 256 for recurrentgemma-9b's MQA layers
//   (G = 16 on one kv head, 4 sequences on a ring of 2048 rows): a warp
//   then holds 128 accumulators a thread, and its ring of three 16-row
//   slices takes 48 KB, so one block of four warps fills an SM's shared
//   memory and the split plan's 1-tile splits (4 x 32 blocks at a full
//   ring) give the 132 SMs a block each.
// - an fp32 q (decode_fp32_launch, and decode_int8_launch with an fp32
//   q): the CUDA-core kernel below, on split_plan's longer splits, held to
//   the plain version at 3e-5. It stages a tile with one load after
//   another per thread and no second tile in flight, so load latency, not
//   bandwidth, sets its time. An int8 cache is read as 16-byte vectors,
//   four K and four V loads of a thread in flight at once, and converted
//   to fp32 in registers while a tile is staged; the row's K scale
//   multiplies its score column after q.k and sm_scale, its V scale folds
//   into P after the row sum and before the P.V product, in the TPU
//   kernel's order.
#include "common.cuh"
#include "decode_tc.cuh"

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

// The tensor-core form: pass 1 (decode_tc.cuh) over split sp of one
// (b, kv head)'s contiguous cache rows, bf16, or int8 with the (BH, S)
// per-row scales ks, vs ...
template <int E, typename KV>
__global__ void __launch_bounds__(dtc::THREADS)
decode_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ k, const KV* __restrict__ v,
                   const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ kv_lens,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int G, int s_len,
                   int tiles_per_split, float scale_log2) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  const int sp = blockIdx.x, bh = blockIdx.y;
  const int kv_len = min(kv_lens[bh], s_len);
  const int row0 = sp * tiles_per_split * KV_TILE;
  if (row0 >= kv_len) return;   // a dead split: the merge stops before it
  const size_t part = (size_t)bh * gridDim.x + sp;
  const size_t kv_off = (size_t)bh * s_len * E;
  const size_t scale_off = Q8 ? (size_t)bh * s_len : 0;
  dtc::split_block<E, 1, false>(
      q + (size_t)bh * G * E, k + kv_off, v + kv_off, DenseRows{E}, kv_len,
      kv_len - 1, G, 1, row0, tiles_per_split, scale_log2, m_part + part * G,
      l_part + part * G, acc_part + part * G * E, ks + scale_off,
      vs + scale_off);
}

// ... and its merge pass, one block per (b, kv head).
template <int E>
__global__ void __launch_bounds__(dtc::MERGE_THREADS)
decode_bf16_merge_kernel(const float* __restrict__ m_part,
                         const float* __restrict__ l_part,
                         const float* __restrict__ acc_part,
                         const int* __restrict__ kv_lens,
                         __nv_bfloat16* __restrict__ o, int G, int s_len,
                         int n_split, int span) {
  const int bh = blockIdx.x;
  const size_t part = (size_t)bh * n_split;
  dtc::merge_splits<E>(m_part + part * G, l_part + part * G,
                       acc_part + part * G * E, o + (size_t)bh * G * E,
                       min(kv_lens[bh], s_len), G, n_split,
                       span);
}

template <int E, typename KV>
int launch_tc(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const int* kv_lens, void* o, float* m_part,
              float* l_part, float* acc_part, int bh, int G, int s_len,
              int n_split, int tiles_per_split, float sm_scale,
              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int smem =
      dtc::smem_bytes<E, 1, std::is_same<KV, int8_t>::value>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_bf16_kernel<E, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  decode_bf16_kernel<E, KV>
      <<<dim3(n_split, bh), dtc::THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), kv_lens, m_part, l_part, acc_part,
          G, s_len, tiles_per_split, sm_scale * dtc::LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_bf16_merge_kernel<E><<<bh, dtc::MERGE_THREADS, 0, stream>>>(
      m_part, l_part, acc_part, kv_lens, static_cast<bf16*>(o), G, s_len,
      n_split, tiles_per_split * KV_TILE);
  return (int)cudaGetLastError();
}

// The tensor-core form for head dim E: 64, 128 or 256, G <= 16.
template <typename KV>
int dispatch_tc(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* kv_lens, void* o, void* m_part,
                void* l_part, void* acc_part, int bh, int G, int s_len,
                int E, int n_split, int tiles_per_split, float sm_scale,
                void* stream) {
  if (G > MAXG || (E != 64 && E != 128 && E != 256))
    return (int)cudaErrorInvalidValue;
#define REPRO_DECODE_ARGS                                                 \
  q, k, v, ks, vs, static_cast<const int*>(kv_lens), o,                   \
      static_cast<float*>(m_part), static_cast<float*>(l_part),           \
      static_cast<float*>(acc_part), bh, G, s_len, n_split,               \
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream)
  if (E == 256) return launch_tc<256, KV>(REPRO_DECODE_ARGS);
  return E == 128 ? launch_tc<128, KV>(REPRO_DECODE_ARGS)
                  : launch_tc<64, KV>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
}

}  // namespace

// q: (bh, G, E); k, v: (bh, s_len, E) of q's type, or int8 with ks, vs
// the (bh, s_len) fp32 per-row scales; kv_lens: (bh,) int32 on the
// device; o: (bh, G, E). Scratch: m_part, l_part (bh, n_split, G) and
// acc_part (bh, n_split, G, E), fp32. Split sp covers KV tiles
// [sp * tiles_per_split, (sp + 1) * tiles_per_split). Contiguous.

// bf16 q and caches, on the tensor cores: E 64, 128 or 256, G <= 16,
// 16-byte aligned rows.
extern "C" int decode_bf16_launch(const void* q, const void* k,
                                  const void* v, const void* kv_lens,
                                  void* o, void* m_part, void* l_part,
                                  void* acc_part, int bh, int G, int s_len,
                                  int E, int n_split, int tiles_per_split,
                                  float sm_scale, void* stream) {
  return dispatch_tc<__nv_bfloat16>(q, k, v, nullptr, nullptr, kv_lens, o,
                                    m_part, l_part, acc_part, bh, G, s_len,
                                    E, n_split, tiles_per_split, sm_scale,
                                    stream);
}

// fp32 q and caches, on the CUDA cores.
extern "C" int decode_fp32_launch(const void* q, const void* k,
                                  const void* v, const void* kv_lens,
                                  void* o, void* m_part, void* l_part,
                                  void* acc_part, int bh, int G, int s_len,
                                  int E, int n_split, int tiles_per_split,
                                  float sm_scale, void* stream) {
  return launch<float, float>(
      q, k, v, nullptr, nullptr, static_cast<const int*>(kv_lens), o,
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), bh, G, s_len, E, n_split,
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream));
}

// int8 caches with their per-row scales: a bf16 q (dtype 1) on the tensor
// cores (E 64, 128 or 256, G <= 16, 16-byte aligned rows), an fp32 q
// (dtype 0) on the CUDA cores.
extern "C" int decode_int8_launch(const void* q, const void* k,
                                  const void* v, const void* ks,
                                  const void* vs, const void* kv_lens,
                                  void* o, void* m_part, void* l_part,
                                  void* acc_part, int bh, int G, int s_len,
                                  int E, int n_split, int tiles_per_split,
                                  float sm_scale, int dtype, void* stream) {
  if (dtype != 0)
    return dispatch_tc<int8_t>(q, k, v, ks, vs, kv_lens, o, m_part, l_part,
                               acc_part, bh, G, s_len, E, n_split,
                               tiles_per_split, sm_scale, stream);
  return launch<float, int8_t>(
      q, k, v, ks, vs, static_cast<const int*>(kv_lens), o,
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), bh, G, s_len, E, n_split,
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream));
}
