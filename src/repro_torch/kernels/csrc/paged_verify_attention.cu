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
// with k = 1 the kernel is B6 exactly (same split, tiles and merge). The
// TPU kernel pads the group to its 8-row sublane tile; here the block is
// k * G rows as they are.
//
// The design is B6's (paged_split.cuh): grid (n_split, B * Hkv), the split
// planned over the table's capacity so no host sync is needed, 64-row
// tiles gathered row by row through the page table, and a second pass
// that merges the partial (m, l, acc). B5's banding folds in with the
// k-block as the diagonal: tiles wholly below min(q_starts + 1, kv_len)
// run unmasked, tiles that straddle the block's diagonal or the kv_len
// tail take the fused select with row position q_starts + i / G, dead
// tiles are never loaded. int8 pools are read as 16-byte vectors,
// converted to fp32 in registers, and scaled per tile column through the
// table (K scale on the score, V scale folded into P).
//
// What bounds it on an H100: a verify step reads every live K and V row
// once for all k positions, so it does k times B6's arithmetic on the same
// bytes, about k * G / 2 multiply-adds a byte of bf16 pool: at k * G = 8
// it is still far below the ~295 operations a byte where the tensor cores
// would become the limit, and its floor is device-memory bandwidth over
// the live rows. This first version shares B6's staging, one load after
// another per thread with no second tile in flight, so load latency sets
// its time; each staged tile now serves k times more rows than in decode.
#include "paged_split.cuh"

namespace {
constexpr int MAXR = 32;      // k * G query rows per (b, kv head)
}  // namespace

// q: (B, Hkv, R, E) with R = spec * G, position-major; k, v: (Hkv,
// n_pages, page_size, E), of q's type, or int8 when `quantized` with ks,
// vs the (Hkv, n_pages) fp32 per-page scales; table: (B, max_pages),
// kv_lens and q_starts: (B,), int32 on the device; o: like q. Scratch:
// m_part, l_part (B * Hkv, n_split, R) and acc_part
// (B * Hkv, n_split, R, E), fp32. Contiguous.
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* kv_lens,
    const void* q_starts, void* o, void* m_part, void* l_part,
    void* acc_part, int B, int Hkv, int R, int G, int n_pages, int page_size,
    int max_pages, int E, int n_split, int tiles_per_split, float sm_scale,
    int dtype, int quantized, void* stream) {
  return repro::paged_split_dispatch<MAXR, true>(
      q, k, v, ks, vs, table, kv_lens, q_starts, o, m_part, l_part, acc_part,
      B, Hkv, R, G, n_pages, page_size, max_pages, E, n_split,
      tiles_per_split, sm_scale, dtype, quantized, stream);
}
