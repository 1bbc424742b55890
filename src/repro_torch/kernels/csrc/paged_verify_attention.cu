// Speculative-verify attention over a paged KV pool for Hopper: kernel B7.
//
// Replaces the Pallas kernel repro/kernels/paged_verify_attention.py
// (paged_verify_attention_flat; body _paged_verify_kernel), both its
// bf16/fp32 pool branch and its int8 branch with per-page scales.
//
// What it computes: each live slot b has written k candidate K/V rows
// (its last emitted token and up to k - 1 drafted ones) into its pages at
// positions q_starts[b] .. q_starts[b] + n_rows - 1, with kv_lens[b] =
// q_starts[b] + n_rows. Its k query positions attend, in one pass, to all
// prior context and to the candidates at or before themselves. Per
// (b, kv head) the Q block is (k * G, E), position-major: row i is query
// head i % G of position q_starts[b] + i / G. Rows past kv_len see the
// whole live context and are dropped by the host. kv_len 0 gives zeros;
// with k = 1 and q_starts = kv_len - 1 each form is B6's form of the same
// dtypes exactly (same split, tiles or slices, and merge). The TPU kernel
// pads the group to its 8-row sublane tile; here the block is k * G rows
// as they are.
//
// The forms, chosen by the caller by dtype (paged_verify_attention.py's
// entry_point), none falling back to another:
// - a bf16 q on bf16 pools (paged_verify_bf16_launch) and on int8 pools
//   (paged_verify_int8_launch with a bf16 q): the tensor-core design of
//   decode_tc.cuh, shared with B4's and B6's bf16-q forms. Short splits
//   (decode_split_plan: 1-4 tiles a block, over the table's capacity, so
//   no host sync) spread the longest sequence over every SM; each warp
//   walks 16-row slices, one page of 16 rows each at the engine's page
//   size, through a 3-slot cp.async ring of its own, with its own online
//   softmax and no __syncthreads a tile; S and P V are mma.sync products
//   with the k * G rows padded to 16 or 32 (one or two m16 tiles) and P as
//   bf16 hi + lo. An int8 page lands raw with its rows' page scales and
//   each lane converts the chunks it copied to bf16 (exact) into its
//   warp's slot; the K scale multiplies the score, the V scale P after
//   the row sum. B5's banding folds in with the k-block as the diagonal:
//   slices wholly below min(q_starts + 1, kv_len) run unmasked, later live
//   slices take the fused select with row position q_starts + i / G, dead
//   slices are never loaded. The merge pass is
//   paged_verify_bf16_merge_kernel, for both pools.
// - an fp32 q (paged_verify_fp32_launch, and paged_verify_int8_launch
//   with an fp32 q): the CUDA-core split-KV kernel (paged_split.cuh) at up
//   to 32 rows, on split_plan, shared with B6's fp32-q forms: grid
//   (n_split, B * Hkv), 64-row tiles gathered row by row through the page
//   table, a second pass that merges the partial (m, l, acc). int8 pools
//   are read as 16-byte vectors, converted to fp32 in registers, and
//   scaled per tile column through the table (K scale on the score, V
//   scale folded into P).
//
// What bounds it on an H100: a verify step reads every live K and V row
// once for all k positions, so it does k times B6's arithmetic on the same
// bytes, about k * G / 2 multiply-adds a byte of bf16 pool: at k * G = 8
// it is still far below the ~295 operations a byte where the tensor cores
// would become the limit, and its floor is device-memory bandwidth over
// the live rows. On the CUDA cores those k * G FMAs a loaded element cost
// instructions the bf16 form moves to the tensor cores.
#include "paged_split.cuh"

#include "decode_tc.cuh"

namespace {

using namespace repro;

constexpr int MAXR = 32;      // k * G query rows per (b, kv head)

// The tensor-core form: pass 1 (decode_tc.cuh) over split sp of one
// (b, kv head)'s logical rows, gathered through its page table from a
// bf16 pool, or an int8 pool with its (Hkv, P) page scales ks, vs ...
template <int E, int MT, typename KV>
__global__ void __launch_bounds__(dtc::THREADS)
paged_verify_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const KV* __restrict__ k, const KV* __restrict__ v,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ q_starts,
                         float* __restrict__ m_part,
                         float* __restrict__ l_part,
                         float* __restrict__ acc_part, int Hkv, int R, int G,
                         int n_pages, int page_size, int max_pages,
                         int tiles_per_split, float scale_log2) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  const int sp = blockIdx.x, bh = blockIdx.y;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int kv_len = min(kv_lens[b], max_pages * page_size);
  const int row0 = sp * tiles_per_split * KV_TILE;
  if (row0 >= kv_len) return;   // a dead split: the merge stops before it
  const size_t part = (size_t)bh * gridDim.x + sp;
  const size_t head_off = (size_t)h * n_pages * page_size * E;
  const size_t scale_off = Q8 ? (size_t)h * n_pages : 0;
  dtc::split_block<E, MT, true>(
      q + (size_t)bh * R * E, k + head_off, v + head_off,
      PagedRows{table + (size_t)b * max_pages, page_size, 0, E}, kv_len,
      q_starts[b], R, G, row0, tiles_per_split, scale_log2,
      m_part + part * R, l_part + part * R, acc_part + part * R * E,
      ks + scale_off, vs + scale_off);
}

// ... and its merge pass, one block per (b, kv head).
template <int E>
__global__ void __launch_bounds__(dtc::MERGE_THREADS)
paged_verify_bf16_merge_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ acc_part,
                               const int* __restrict__ kv_lens,
                               __nv_bfloat16* __restrict__ o, int Hkv, int R,
                               int kv_cap, int n_split, int span) {
  const int bh = blockIdx.x;
  const size_t part = (size_t)bh * n_split;
  dtc::merge_splits<E>(m_part + part * R, l_part + part * R,
                       acc_part + part * R * E, o + (size_t)bh * R * E,
                       min(kv_lens[bh / Hkv], kv_cap), R, n_split, span);
}

template <int E, int MT, typename KV>
int launch_tc(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* table, const void* kv_lens,
              const void* q_starts, void* o, void* m_part, void* l_part,
              void* acc_part, int B, int Hkv, int R, int G, int n_pages,
              int page_size, int max_pages, int n_split, int tiles_per_split,
              float sm_scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int smem =
      dtc::smem_bytes<E, MT, std::is_same<KV, int8_t>::value>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_verify_bf16_kernel<E, MT, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  const int* lens = static_cast<const int*>(kv_lens);
  paged_verify_bf16_kernel<E, MT, KV>
      <<<dim3(n_split, B * Hkv), dtc::THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          lens, static_cast<const int*>(q_starts), mp, lp, ap, Hkv, R, G,
          n_pages, page_size, max_pages, tiles_per_split,
          sm_scale * dtc::LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_verify_bf16_merge_kernel<E>
      <<<B * Hkv, dtc::MERGE_THREADS, 0, stream>>>(
          mp, lp, ap, lens, static_cast<bf16*>(o), Hkv, R,
          max_pages * page_size, n_split, tiles_per_split * KV_TILE);
  return (int)cudaGetLastError();
}

// The tensor-core form for head dim E (64 or 128), R <= 32 rows of
// G <= 16 heads: one m16 tile of rows up to 16, two beyond.
template <typename KV>
int dispatch_tc(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* table, const void* kv_lens,
                const void* q_starts, void* o, void* m_part, void* l_part,
                void* acc_part, int B, int Hkv, int R, int G, int n_pages,
                int page_size, int max_pages, int E, int n_split,
                int tiles_per_split, float sm_scale, void* stream) {
  if (R > MAXR || G > 16 || (E != 64 && E != 128))
    return (int)cudaErrorInvalidValue;
#define REPRO_VERIFY_ARGS                                                  \
  q, k, v, ks, vs, table, kv_lens, q_starts, o, m_part, l_part, acc_part, \
      B, Hkv, R, G, n_pages, page_size, max_pages, n_split,                \
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream)
  if (E == 128)
    return R > 16 ? launch_tc<128, 2, KV>(REPRO_VERIFY_ARGS)
                  : launch_tc<128, 1, KV>(REPRO_VERIFY_ARGS);
  return R > 16 ? launch_tc<64, 2, KV>(REPRO_VERIFY_ARGS)
                : launch_tc<64, 1, KV>(REPRO_VERIFY_ARGS);
#undef REPRO_VERIFY_ARGS
}

}  // namespace

// q: (B, Hkv, R, E) with R = spec * G, position-major; k, v: (Hkv,
// n_pages, page_size, E), of q's type, or int8 with ks, vs the (Hkv,
// n_pages) fp32 per-page scales; table: (B, max_pages), kv_lens and
// q_starts: (B,), int32 on the device; o: like q. Scratch: m_part, l_part
// (B * Hkv, n_split, R) and acc_part (B * Hkv, n_split, R, E), fp32.
// Contiguous.

// bf16 q and pools, on the tensor cores: E 64 or 128, R <= 32, G <= 16,
// 16-byte aligned rows.
extern "C" int paged_verify_bf16_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* kv_lens, const void* q_starts, void* o, void* m_part,
    void* l_part, void* acc_part, int B, int Hkv, int R, int G, int n_pages,
    int page_size, int max_pages, int E, int n_split, int tiles_per_split,
    float sm_scale, void* stream) {
  return dispatch_tc<__nv_bfloat16>(
      q, k, v, nullptr, nullptr, table, kv_lens, q_starts, o, m_part, l_part,
      acc_part, B, Hkv, R, G, n_pages, page_size, max_pages, E, n_split,
      tiles_per_split, sm_scale, stream);
}

// fp32 q and pools, on the CUDA cores.
extern "C" int paged_verify_fp32_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* kv_lens, const void* q_starts, void* o, void* m_part,
    void* l_part, void* acc_part, int B, int Hkv, int R, int G, int n_pages,
    int page_size, int max_pages, int E, int n_split, int tiles_per_split,
    float sm_scale, void* stream) {
  return repro::paged_split_launch<float, float, MAXR, true>(
      q, k, v, nullptr, nullptr, table, kv_lens, q_starts, o, m_part, l_part,
      acc_part, B, Hkv, R, G, n_pages, page_size, max_pages, E, n_split,
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream));
}

// int8 pools with their per-page scales: a bf16 q (dtype 1) on the tensor
// cores (E 64 or 128, R <= 32, G <= 16, 16-byte aligned rows), an fp32 q
// (dtype 0) on the CUDA cores.
extern "C" int paged_verify_int8_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* kv_lens,
    const void* q_starts, void* o, void* m_part, void* l_part,
    void* acc_part, int B, int Hkv, int R, int G, int n_pages, int page_size,
    int max_pages, int E, int n_split, int tiles_per_split, float sm_scale,
    int dtype, void* stream) {
  if (dtype != 0)
    return dispatch_tc<int8_t>(q, k, v, ks, vs, table, kv_lens, q_starts, o,
                               m_part, l_part, acc_part, B, Hkv, R, G,
                               n_pages, page_size, max_pages, E, n_split,
                               tiles_per_split, sm_scale, stream);
  return repro::paged_split_launch<float, int8_t, MAXR, true>(
      q, k, v, ks, vs, table, kv_lens, q_starts, o, m_part, l_part, acc_part,
      B, Hkv, R, G, n_pages, page_size, max_pages, E, n_split,
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream));
}
