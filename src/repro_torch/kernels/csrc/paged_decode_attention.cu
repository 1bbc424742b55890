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
// arrays the kernel reads itself, so a decode step needs no host sync.
// Pass 1 splits the logical rows into 64-row tiles and the tiles over
// gridDim.x blocks per (b, h); each block walks its tiles with an online
// max/sum, stopping at the first tile at or past kv_len (no load), and
// writes a partial (m, l, acc). Pass 2 (split_combine_kernel) merges the
// partials; a sequence with kv_len 0 gets zeros (l == 0 divides by 1).
// Both passes live in paged_split.cuh, shared with B7 (paged verify): a
// decode step is a verify block of one position. int8 pools are read as
// 16-byte vectors, converted to fp32 while staged, and their per-page
// scales are looked up per tile column through the table.
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
// in flight, so load latency, not bandwidth, sets its time. An int8 pool
// halves the bytes a bf16 pool moves.
#include "paged_split.cuh"

namespace {
constexpr int MAXG = 16;      // query heads per kv head
}  // namespace

// q: (B, Hkv, G, E); k, v: (Hkv, n_pages, page_size, E), of q's type, or
// int8 when `quantized` with ks, vs the (Hkv, n_pages) fp32 per-page
// scales; table: (B, max_pages) int32 and kv_lens: (B,) int32 on the
// device; o: like q. Scratch: m_part, l_part (B * Hkv, n_split, G) and
// acc_part (B * Hkv, n_split, G, E), fp32. Split sp covers the 64-row
// tiles [sp * tiles_per_split, (sp + 1) * tiles_per_split) of the logical
// rows. Contiguous.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* kv_lens, void* o,
    void* m_part, void* l_part, void* acc_part, int B, int Hkv, int G,
    int n_pages, int page_size, int max_pages, int E, int n_split,
    int tiles_per_split, float sm_scale, int dtype, int quantized,
    void* stream) {
  return repro::paged_split_dispatch<MAXG, false>(
      q, k, v, ks, vs, table, kv_lens, nullptr, o, m_part, l_part, acc_part,
      B, Hkv, G, G, n_pages, page_size, max_pages, E, n_split,
      tiles_per_split, sm_scale, dtype, quantized, stream);
}
