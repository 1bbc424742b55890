// Split-KV one-token decode over a paged KV pool for Hopper: kernel B6.
//
// Replaces the Pallas kernel repro/kernels/paged_decode_attention.py
// (paged_decode_attention_flat; body _paged_decode_kernel), both its
// bf16/fp32 pool branch and its int8 branch with per-page scales.
//
// What it computes: for each (sequence b, kv head h) the G query heads of
// its GQA group attend to the first kv_lens[b] logical rows of the
// sequence, gathered from the pool (Hkv, P, page_size, E) through its row
// of the page table (B, max_pages). Both the table and kv_lens are device
// arrays the kernel reads itself, and the split is planned over the
// table's capacity, so a decode step needs no host sync. Pass 1 splits the
// logical rows into 64-row tiles and the tiles over gridDim.x blocks per
// (b, h); pass 2 merges the partial (m, l, acc). kv_len 0 gives zeros.
//
// Three forms, chosen by the caller by dtype (paged_decode_attention.py's
// entry_point), none falling back to another:
// - bf16 q on bf16 pools (paged_decode_bf16_launch) and on int8 pools
//   (paged_decode_int8_launch with a bf16 q): the tensor-core design of
//   decode_tc.cuh, shared with the bf16 forms of B4 and B7. Short splits
//   (decode_split_plan: 1-4 tiles a block) spread the longest sequence
//   over every SM, and blocks past kv_len exit after reading it; each of a
//   block's four warps walks 16-row slices, one page of 16 rows each at
//   the engine's page size, through a 3-slot cp.async ring of its own,
//   with its own online softmax and no __syncthreads a tile; S and P V are
//   mma.sync products with the G rows padded to one m16 tile and P as bf16
//   hi + lo. An int8 page lands raw with its rows' page scales and each
//   lane converts the chunks it copied to bf16 (exact) into its warp's
//   slot; the K scale multiplies the score, the V scale P after the row
//   sum. The merge pass is paged_decode_bf16_merge_kernel, for both pools.
// - fp32 q (paged_decode_fp32_launch, and paged_decode_int8_launch with
//   an fp32 q): the CUDA-core kernel of paged_split.cuh on split_plan,
//   shared with B7's fp32-q forms, so that a verify of one position
//   is B6 exactly: 64-row tiles gathered row by row through the table and
//   staged in shared memory as fp32 (int8 converted in registers, scales
//   per tile column), then split_combine_kernel.
//
// What bounds it on an H100: one query row per head reads every live K
// and V row once, G/2 multiply-adds a byte of a bf16 pool (G a byte of an
// int8 one), far below the ~295 operations a byte where the tensor cores
// would become the limit, so its floor is device-memory bandwidth over
// the live rows; an int8 pool halves the bytes. The CUDA-core form stages
// one tile at a time with one load after another, so load latency, not
// bandwidth, sets its time; the tensor-core forms keep two 16-row slices
// a warp in flight while one is multiplied.
#include "paged_split.cuh"

#include "decode_tc.cuh"

namespace {

using namespace repro;

constexpr int MAXG = 16;      // query heads per kv head

// The tensor-core form: pass 1 (decode_tc.cuh) over split sp of one
// (b, kv head)'s logical rows, gathered through its page table from a
// bf16 pool, or an int8 pool with its (Hkv, P) page scales ks, vs ...
template <int E, typename KV>
__global__ void __launch_bounds__(dtc::THREADS)
paged_decode_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const KV* __restrict__ k, const KV* __restrict__ v,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         const int* __restrict__ kv_lens,
                         float* __restrict__ m_part,
                         float* __restrict__ l_part,
                         float* __restrict__ acc_part, int Hkv, int G,
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
  dtc::split_block<E, 1, false>(
      q + (size_t)bh * G * E, k + head_off, v + head_off,
      PagedRows{table + (size_t)b * max_pages, page_size, 0, E}, kv_len,
      kv_len - 1, G, 1, row0, tiles_per_split, scale_log2,
      m_part + part * G, l_part + part * G, acc_part + part * G * E,
      ks + scale_off, vs + scale_off);
}

// ... and its merge pass, one block per (b, kv head).
template <int E>
__global__ void __launch_bounds__(dtc::MERGE_THREADS)
paged_decode_bf16_merge_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ acc_part,
                               const int* __restrict__ kv_lens,
                               __nv_bfloat16* __restrict__ o, int Hkv, int G,
                               int kv_cap, int n_split, int span) {
  const int bh = blockIdx.x;
  const size_t part = (size_t)bh * n_split;
  dtc::merge_splits<E>(m_part + part * G, l_part + part * G,
                       acc_part + part * G * E, o + (size_t)bh * G * E,
                       min(kv_lens[bh / Hkv], kv_cap), G, n_split, span);
}

template <int E, typename KV>
int launch_tc(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* table, const void* kv_lens,
              void* o, void* m_part, void* l_part, void* acc_part, int B,
              int Hkv, int G, int n_pages, int page_size, int max_pages,
              int n_split, int tiles_per_split, float sm_scale,
              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int smem =
      dtc::smem_bytes<E, 1, std::is_same<KV, int8_t>::value>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_bf16_kernel<E, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  const int* lens = static_cast<const int*>(kv_lens);
  paged_decode_bf16_kernel<E, KV>
      <<<dim3(n_split, B * Hkv), dtc::THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table), lens,
          mp, lp, ap, Hkv, G, n_pages, page_size, max_pages, tiles_per_split,
          sm_scale * dtc::LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_bf16_merge_kernel<E>
      <<<B * Hkv, dtc::MERGE_THREADS, 0, stream>>>(
          mp, lp, ap, lens, static_cast<bf16*>(o), Hkv, G,
          max_pages * page_size, n_split, tiles_per_split * KV_TILE);
  return (int)cudaGetLastError();
}

// The tensor-core form for head dim E: 64 or 128, G <= 16.
template <typename KV>
int dispatch_tc(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* table, const void* kv_lens,
                void* o, void* m_part, void* l_part, void* acc_part, int B,
                int Hkv, int G, int n_pages, int page_size, int max_pages,
                int E, int n_split, int tiles_per_split, float sm_scale,
                void* stream) {
  if (G > MAXG || (E != 64 && E != 128)) return (int)cudaErrorInvalidValue;
#define REPRO_DECODE_ARGS                                                    \
  q, k, v, ks, vs, table, kv_lens, o, m_part, l_part, acc_part, B, Hkv, G, \
      n_pages, page_size, max_pages, n_split, tiles_per_split, sm_scale,   \
      static_cast<cudaStream_t>(stream)
  return E == 128 ? launch_tc<128, KV>(REPRO_DECODE_ARGS)
                  : launch_tc<64, KV>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
}

}  // namespace

// q: (B, Hkv, G, E); k, v: (Hkv, n_pages, page_size, E), of q's type, or
// int8 with ks, vs the (Hkv, n_pages) fp32 per-page scales; table:
// (B, max_pages) int32 and kv_lens: (B,) int32 on the device; o: like q.
// Scratch: m_part, l_part (B * Hkv, n_split, G) and acc_part (B * Hkv,
// n_split, G, E), fp32. Split sp covers the 64-row tiles
// [sp * tiles_per_split, (sp + 1) * tiles_per_split) of the logical rows.
// Contiguous.

// bf16 q and pools, on the tensor cores: E 64 or 128, G <= 16, 16-byte
// aligned rows.
extern "C" int paged_decode_bf16_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* kv_lens, void* o, void* m_part, void* l_part, void* acc_part,
    int B, int Hkv, int G, int n_pages, int page_size, int max_pages, int E,
    int n_split, int tiles_per_split, float sm_scale, void* stream) {
  return dispatch_tc<__nv_bfloat16>(
      q, k, v, nullptr, nullptr, table, kv_lens, o, m_part, l_part, acc_part,
      B, Hkv, G, n_pages, page_size, max_pages, E, n_split, tiles_per_split,
      sm_scale, stream);
}

// fp32 q and pools, on the CUDA cores.
extern "C" int paged_decode_fp32_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* kv_lens, void* o, void* m_part, void* l_part, void* acc_part,
    int B, int Hkv, int G, int n_pages, int page_size, int max_pages, int E,
    int n_split, int tiles_per_split, float sm_scale, void* stream) {
  return repro::paged_split_launch<float, float, MAXG, false>(
      q, k, v, nullptr, nullptr, table, kv_lens, nullptr, o, m_part, l_part,
      acc_part, B, Hkv, G, G, n_pages, page_size, max_pages, E, n_split,
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream));
}

// int8 pools with their per-page scales: a bf16 q (dtype 1) on the tensor
// cores (E 64 or 128, G <= 16, 16-byte aligned rows), an fp32 q (dtype 0)
// on the CUDA cores.
extern "C" int paged_decode_int8_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* kv_lens, void* o,
    void* m_part, void* l_part, void* acc_part, int B, int Hkv, int G,
    int n_pages, int page_size, int max_pages, int E, int n_split,
    int tiles_per_split, float sm_scale, int dtype, void* stream) {
  if (dtype != 0)
    return dispatch_tc<int8_t>(q, k, v, ks, vs, table, kv_lens, o, m_part,
                               l_part, acc_part, B, Hkv, G, n_pages,
                               page_size, max_pages, E, n_split,
                               tiles_per_split, sm_scale, stream);
  return repro::paged_split_launch<float, int8_t, MAXG, false>(
      q, k, v, ks, vs, table, kv_lens, nullptr, o, m_part, l_part, acc_part,
      B, Hkv, G, G, n_pages, page_size, max_pages, E, n_split,
      tiles_per_split, sm_scale, static_cast<cudaStream_t>(stream));
}
