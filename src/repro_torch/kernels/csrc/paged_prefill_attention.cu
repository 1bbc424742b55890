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
// kv_len see every live key and are dropped by the caller. q_offset and
// kv_len are an int32 pair in device memory (span) that every block reads
// at its start, as the TPU kernel reads them by scalar prefetch: no launch
// argument changes from one chunk to the next. A kv_len past the table's
// rows (table_rows = max_pages * page_size, multiplied on the host: with
// the product formed in the kernel, page_size held a register and B5 on
// int8 pools ran 2% slower, measured on an H100) is cut to them, as the
// TPU kernel's grid over the table ends there.
//
// The TPU kernel keeps a whole (chunk, E) fp32 accumulator per head on
// chip; at chunk 512 that is 256 KB, past the 227 KB a block may hold. So
// one thread block owns one (query head, block of Q rows) and walks
// 64-row tiles of logical kv rows with an online max/sum, in the
// three-band order of the TPU kernel: tiles wholly below the block's
// first row and below kv_len run with no mask; tiles that straddle the
// causal diagonal or the kv_len tail take the fused select
// cols <= rows && cols < kv_len; tiles past the block's last row or at or
// past kv_len are dead and never loaded. For an int8 pool each tile
// column's per-page scales are looked up through the page table (a 64-row
// tile spans several pages); the K scale multiplies the score after q.k
// and sm_scale, the V scale folds into P after the row sum.
//
// The fp32 form (paged_prefill_fp32_launch, both pool branches) runs its
// products on the CUDA cores in fp32, blocks of blk_q rows, one tile
// staged at a time; an int8 pool is read as 16-byte vectors, four K and
// four V loads of a thread in flight, converted to fp32 while staged.
//
// The bf16 form (paged_prefill_bf16_launch: bf16 Q, a bf16 or an int8
// pool, head dim 64 or 128) is bound by its tensor-core products and by
// the gather of each tile from L2 (a late 512-row chunk of a 3584-row
// sequence is 14 GFLOP of visible pairs; each of its 128 blocks gathers
// up to 56 tiles of 32 KB). Its design:
// - 64-row blocks of one consumer warpgroup, so each gathered tile serves
//   64 rows; the online-softmax step of flash_tile.cuh, shared with B3:
//   S = Q K^T and P V by wgmma, S and P in registers, the masks evaluated
//   in registers from the span, P as bf16 hi + lo.
// - A producer warpgroup keeps a ring of three stages filling: it copies
//   a tile's rows by cp.async, 16 bytes a thread, page by page through
//   the page ids the block read from the table once (room for the whole
//   table row is reserved, since the live rows are known only on the
//   device), and an mbarrier counts them in. A warp that issues copies
//   stalls while the memory pipe takes them (in one warpgroup that did
//   both, measured on an H100, the copies and the products took as long
//   as the two apart added up); in warps of their own the stalls overlap
//   the products.
// - A bf16 pool lands straight in the 128-byte-swizzled tiles the wgmma
//   descriptors read; rows past kv_len are zero-filled. An int8 pool is
//   loaded by the producers as 16-byte vectors, converted to bf16 (exact:
//   every value in -127..127 has 8 significant bits) and stored into the
//   same tiles with the tile's per-column page scales (converted by the
//   consumers instead, the int8 late chunk ran slower than the bf16 one
//   on an H100), so both pools run one wgmma core.
// - Q's fragments are loaded from shared memory for every tile. Held in
//   registers across the tile loop, one of them was overwritten after the
//   first tile at head dim 64 (the compiler gave its register to the
//   scaled scores), which made every later tile's scores wrong.
#include "flash_tile.cuh"

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
                     const int* __restrict__ table,
                     const int* __restrict__ span, T* __restrict__ o,
                     int nq, int E, int group, int blk_q, int n_pages,
                     int page_size, int table_rows, float sm_scale) {
  using S = typename TileOf<T, KV>::type;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  const int q_offset = __ldg(span);
  const int kv_len = min(__ldg(span + 1), table_rows);
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
           const void* vs, const int* table, const int* span, void* o, int hq,
           int nq, int E, int group, int blk_q, int n_pages, int page_size,
           int max_pages, float sm_scale, cudaStream_t stream) {
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
      static_cast<const float*>(vs), table, span, static_cast<T*>(o), nq, E,
      group, blk_q, n_pages, page_size, max_pages * page_size, sm_scale);
  return (int)cudaGetLastError();
}

constexpr int BQ = 64;         // bf16 form: query rows a block
constexpr int CONSUMERS = 128; // one warpgroup: 4 warps of 16 rows
constexpr int PRODUCERS = 128; // and one warpgroup that gathers
constexpr int WS_THREADS = CONSUMERS + PRODUCERS;
constexpr int STAGES = 3;      // tiles in flight: the ring's depth
// named barriers: stage s free again (consumers to producer); the
// consumers among themselves
__host__ __device__ constexpr int empty_bar(int s) { return 1 + s; }
constexpr int CONSUMER_BAR = 1 + STAGES;

// Shared-memory layout of the bf16 form from the 1024-aligned base: the
// Q tile, the ring's STAGES stages (bf16 K and V tiles, and for an int8
// pool their per-column scales), the ring's mbarriers, and room for the
// page ids of the whole table row (the block reads those of its live
// rows).
template <int E, bool Q8>
struct Smem {
  static constexpr int TILE = KV_TILE * E * 2;          // a bf16 K or V tile
  static constexpr int STAGE = 2 * TILE + (Q8 ? 1024 : 0);
  static constexpr int Q = 0;
  static constexpr int RING = BQ * E * 2;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int IDS = BARS + 8 * STAGES;
};

// Two bf16 values in one word (x in the low half).
__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// Sixteen int8 values (one 16-byte vector) as sixteen bf16 values, stored
// as the two 16-byte chunks at columns col and col + 8 of row r of the
// sw128 tile at dst. Exact: every int8 value has 8 significant bits.
__device__ __forceinline__ void st_q8_as_bf16(uint32_t dst, int r, int col,
                                              uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = q8x4(w[i]);
    b[2 * i] = bf16x2(f.x, f.y);
    b[2 * i + 1] = bf16x2(f.z, f.w);
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   dst + tc::sw128<KV_TILE>(r, col)),
               "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3])
               : "memory");
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   dst + tc::sw128<KV_TILE>(r, col + 8)),
               "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7])
               : "memory");
}

// The bf16 form: warps 0-3 (one warpgroup) compute, warps 4-7 gather.
// The producers fill the ring's stages in tile order, each stage once the
// consumers have freed it; a stage's mbarrier completes when every
// producer thread's copies (bf16 pool) or stores (int8 pool) for it are
// done. One producer warp issued too few copies at a time to keep up.
template <int E, typename KV>
__global__ void __launch_bounds__(WS_THREADS, 1)
paged_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const KV* __restrict__ k, const KV* __restrict__ v,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ table,
                          const int* __restrict__ span,
                          __nv_bfloat16* __restrict__ o, int nq, int group,
                          int n_pages, int page_size, int table_rows,
                          float scale_log2) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  using L = Smem<E, Q8>;
  const int q_offset = __ldg(span);
  const int kv_len = min(__ldg(span + 1), table_rows);
  // the last Q blocks have the most live tiles: they go first
  const int iq = gridDim.x - 1 - blockIdx.x, hq = blockIdx.y;
  const int row0 = q_offset + iq * BQ;   // position of the block's row 0
  const int t = threadIdx.x;
  // Tiles [0, n_full) need no mask; [n_full, n_live) take the select; the
  // rest are dead.
  const int last_col = min(row0 + BQ - 1, kv_len - 1);
  const int n_live = last_col < 0 ? 0 : last_col / KV_TILE + 1;
  const int n_full = max(min(row0 + 1, kv_len), 0) / KV_TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  // sw128 tiles want 1024-byte alignment (the launch adds 1 KB for it)
  const uint32_t base = (tc::smem_addr(smem) + 1023u) & ~1023u;
  unsigned char* const gbase = smem + (base - tc::smem_addr(smem));
  const uint32_t qs = base + L::Q;
  auto stage = [&](int n) { return base + L::RING + (n % STAGES) * L::STAGE; };
  auto full_bar = [&](int n) { return base + L::BARS + 8 * (n % STAGES); };
  int* const pid = reinterpret_cast<int*>(gbase + L::IDS);

  // the page ids of the live rows (at most the table's max_pages), read
  // from the table once; the ring's barriers, each expecting one arrival
  // of every producer thread
  const int n_ids = n_live > 0 ? (min(n_live * KV_TILE, kv_len) - 1) / page_size + 1 : 0;
  for (int i = t; i < n_ids; i += WS_THREADS) pid[i] = __ldg(table + i);
  if (t < STAGES) tc::mbar_init(base + L::BARS + 8 * t, PRODUCERS);
  __syncthreads();

  const int hkv = hq / group;
  const KV* k_head = k + (size_t)hkv * n_pages * page_size * E;
  const KV* v_head = v + (size_t)hkv * n_pages * page_size * E;

  if (t >= CONSUMERS) {
    // Producer warpgroup.
    const int lane = t - CONSUMERS;
    // element offset of logical row pos in its kv head's pages
    auto row_off = [&](int pos) {
      const int pg = pos / page_size;
      return ((size_t)pid[pg] * page_size + (pos - pg * page_size)) * E;
    };
    for (int j = 0; j < n_live; ++j) {
      if (j >= STAGES) tc::bar_sync(empty_bar(j % STAGES), WS_THREADS);
      const uint32_t st = stage(j);
      const int col0 = j * KV_TILE;
      if constexpr (Q8) {
        // 16 int8 values a vector, NV vectors of K and of V a thread
        constexpr int CV = E / 16, NV = KV_TILE * E / 16 / PRODUCERS;
        uint4 kr[NV], vr[NV];
#pragma unroll
        for (int b = 0; b < NV; ++b) {
          const int i = lane + b * PRODUCERS, r = i / CV, c = i % CV;
          kr[b] = vr[b] = make_uint4(0u, 0u, 0u, 0u);
          if (col0 + r < kv_len) {
            const size_t off = row_off(col0 + r) + c * 16;
            kr[b] = __ldg(reinterpret_cast<const uint4*>(k_head + off));
            vr[b] = __ldg(reinterpret_cast<const uint4*>(v_head + off));
          }
        }
        float ksr = 0.f, vsr = 0.f;   // the page scales of column lane
        if (lane < KV_TILE && col0 + lane < kv_len) {
          const size_t page = pid[(col0 + lane) / page_size];
          ksr = __ldg(ks + (size_t)hkv * n_pages + page);
          vsr = __ldg(vs + (size_t)hkv * n_pages + page);
        }
#pragma unroll
        for (int b = 0; b < NV; ++b) {
          const int i = lane + b * PRODUCERS, r = i / CV, c = i % CV;
          st_q8_as_bf16(st, r, c * 16, kr[b]);
          st_q8_as_bf16(st + L::TILE, r, c * 16, vr[b]);
        }
        if (lane < KV_TILE) {
          float* sc = reinterpret_cast<float*>(gbase + (st - base) + 2 * L::TILE);
          sc[lane] = ksr;
          sc[KV_TILE + lane] = vsr;
        }
        tc::fence_proxy_async();   // the stores, to the wgmma that reads them
        tc::mbar_arrive(full_bar(j));
      } else {
        constexpr int CH = E / 8, RSTEP = PRODUCERS / CH;   // 16-byte chunks
        const int c = lane % CH;
#pragma unroll 4
        for (int it = 0; it < KV_TILE / RSTEP; ++it) {
          const int r = lane / CH + it * RSTEP;
          const bool live = col0 + r < kv_len;   // else zero-filled
          const size_t off = live ? row_off(col0 + r) + c * 8 : 0;
          const uint32_t dst = st + tc::sw128<KV_TILE>(r, c * 8);
          tc::cp_async16_zfill(dst, k_head + off, live ? 16 : 0);
          tc::cp_async16_zfill(dst + L::TILE, v_head + off, live ? 16 : 0);
        }
        tc::cp_async_arrive(full_bar(j));
      }
    }
    tc::cp_async_wait<0>();
    return;
  }

  // Consumer warpgroup.
  tc::cp_rows_sw128<E, BQ>(qs, q + ((size_t)hq * nq + iq * BQ) * E, CONSUMERS);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  tc::bar_sync(CONSUMER_BAR, CONSUMERS);

  tc::OnlineRows<E> st;
  st.init();
  for (int j = 0; j < n_live; ++j) {
    tc::mbar_wait(full_bar(j), (j / STAGES) & 1);
    tc::fence_proxy_async();
    const uint32_t kt = stage(j);
    const float* sc = reinterpret_cast<const float*>(gbase + (kt - base) + 2 * L::TILE);
    // Q's fragments are loaded for every tile: nothing of the products'
    // operands is carried from one tile to the next in registers
    uint32_t qf[E / 16][4];
    tc::load_q_fragments<E>(qf, qs);
    const int col0 = j * KV_TILE;
    auto keep = [&](int r, int c) {
      return col0 + c <= row0 + r && col0 + c < kv_len;
    };
    tc::online_tile<E, Q8>(st, qf, kt, kt + L::TILE, scale_log2, j >= n_full,
                           keep, sc, sc + KV_TILE);
    if (j + STAGES < n_live) tc::bar_arrive(empty_bar(j % STAGES), WS_THREADS);
  }
  tc::store_rows<E>(st, o + ((size_t)hq * nq + iq * BQ) * E);
}

template <int E, typename KV>
int launch_bf16(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const int* table, const int* span, void* o,
                int hq, int nq, int group, int n_pages, int page_size,
                int max_pages, float sm_scale, cudaStream_t stream) {
  using L = Smem<E, std::is_same<KV, int8_t>::value>;
  auto kernel = paged_prefill_bf16_kernel<E, KV>;
  // the layout, the page ids of the whole table row, and 1 KB to align
  // the base to 1024 bytes (paged_prefill_attention.bf16_smem_bytes)
  const size_t smem = L::IDS + 4ull * max_pages + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / BQ, hq);
  kernel<<<grid, WS_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), table, span,
      static_cast<__nv_bfloat16*>(o), nq, group, n_pages, page_size,
      max_pages * page_size, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename KV>
int bf16_for_head_dim(int E, const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const int* table,
                      const int* span, void* o, int hq, int nq, int group,
                      int n_pages, int page_size, int max_pages,
                      float sm_scale, cudaStream_t s) {
  if (E == 128)
    return launch_bf16<128, KV>(q, k, v, ks, vs, table, span, o, hq, nq,
                                group, n_pages, page_size, max_pages,
                                sm_scale, s);
  if (E == 64)
    return launch_bf16<64, KV>(q, k, v, ks, vs, table, span, o, hq, nq,
                               group, n_pages, page_size, max_pages, sm_scale,
                               s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (hq, nq, E); k, v: (hq / group, n_pages, page_size, E) of q's type,
// or int8 when `quantized` with ks, vs the (hq / group, n_pages) fp32
// per-page scales; table: (max_pages,) int32 on the device; span: the
// int32 pair (q_offset, kv_len) on the device; o: like q. Contiguous.

// fp32, on the CUDA cores: nq % blk_q == 0.
extern "C" int paged_prefill_fp32_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* span, void* o, int hq,
    int nq, int E, int group, int blk_q, int n_pages, int page_size,
    int max_pages, float sm_scale, int quantized, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* sp = static_cast<const int*>(span);
  if (quantized)
    return launch<float, int8_t>(q, k, v, ks, vs, tab, sp, o, hq, nq, E,
                                 group, blk_q, n_pages, page_size, max_pages,
                                 sm_scale, s);
  return launch<float, float>(q, k, v, ks, vs, tab, sp, o, hq, nq, E, group,
                              blk_q, n_pages, page_size, max_pages, sm_scale,
                              s);
}

// bf16 Q, on the tensor cores (wgmma): E 64 or 128, nq % 64 == 0, q and
// the pools 16-byte aligned.
extern "C" int paged_prefill_bf16_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* span, void* o, int hq,
    int nq, int E, int group, int n_pages, int page_size, int max_pages,
    float sm_scale, int quantized, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* sp = static_cast<const int*>(span);
  if (quantized)
    return bf16_for_head_dim<int8_t>(E, q, k, v, ks, vs, tab, sp, o, hq, nq,
                                     group, n_pages, page_size, max_pages,
                                     sm_scale, s);
  return bf16_for_head_dim<__nv_bfloat16>(E, q, k, v, ks, vs, tab, sp, o, hq,
                                          nq, group, n_pages, page_size,
                                          max_pages, sm_scale, s);
}
