// MAS-Attention for Hopper: kernels B1 (K/V resident) and B2 (K/V streamed).
//
// Replaces the Pallas kernel repro/kernels/mas_attention.py
// (mas_attention_flat; bodies _mas_resident_kernel and _mas_streamed_kernel).
//
// What it computes (paper Alg. 2-4, exact): one thread block owns one
// (b*h, Q row block of blk_q rows). It fills the FULL fp32 (blk_q, N)
// score row in dynamic shared memory tile by tile (S = Q K^T * scale),
// runs ONE exact row softmax over it (no online rescale) and accumulates
// P V over the V tiles. Causal calls prune in three bands
// (causal_tile_bounds): tiles below the diagonal are unmasked, straddling
// tiles pay the in-tile mask, dead tiles are neither loaded nor computed,
// and the softmax only reads the live columns. Columns past kv_len (the
// ops-level padding) are masked.
//
// B1 (mas_resident_*_launch) stages the live K and V rows of its (b*h)
// whole in shared memory next to the score row. B2 is the paper's
// proactive-overwrite regime: K tiles stream through the tile buffer for
// the S pass, and the P V pass reads the V tiles AGAIN from device memory
// into that same buffer (the read inflation sim/ models).
//
// The fp32 forms (mas_resident_fp32_launch, mas_streamed_fp32_launch) run
// their products on the CUDA cores in fp32 (FMA): bound by instructions
// and load latency, far below the tensor-core rate. The bf16 forms
// (mas_resident_bf16_launch, mas_streamed_bf16_launch) run them on the
// tensor cores. B2's is bound by re-staging K and V tiles from L2 into
// shared memory and by the latency of each step: each tile serves only
// blk_q rows (16 at N = 2048), the score row leaves room for one block an
// SM, and that one block's copies are its only source of parallelism. On
// an H100 one block pulls L2 data at ~13 bytes a clock by cp.async three
// stages deep, ~19 by TMA bulk copies, ~30 by loads two stages ahead
// through registers (scripts/copy_rate.py). B1's holds at most 320 rows
// of K and V (the policy's resident threshold at E 128) and is bound by
// the latency of its one pass over them: it copies them once, all at
// once, and overlaps the copies with the products. Their design:
// - S = Q K^T and P V on the tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 sums; mma.cuh). At blk_q 16 or 32 the Q block is the M side. At
//   blk_q 8 the products are transposed (S^T = K Q^T, O^T = V^T P^T), so
//   K rows and E fill the M side and no half of an m16 tile is wasted.
// - The S fragments are scaled (base 2) and masked in registers, their
//   rows' maxima kept, and written fp32 into the row, whose 8-float groups
//   are XOR-swizzled by row so the fragment stores and loads meet no bank
//   conflict. The softmax (the paper's VEC stream) stays on the CUDA
//   cores, one warp a row, and reads the row once: P = exp2(s - m) in
//   place and the row sum l; the output is divided by l. P enters P V as
//   bf16 hi + lo fragments read from the fp32 row.
// - B2: K and V stream as 32-row half tiles, unpadded and chunk-swizzled,
//   16 bytes a thread through registers: the loads of the next two half
//   tiles are in flight while one is multiplied, and the first V loads
//   while the softmax runs. Two half-tile buffers fit the footprint
//   core/policy.py charges (the Q block's fp32 region plus the padded
//   64-row tile buffer); Q is staged once at the head of the score row and
//   held in registers.
// - B1: Q, each live K tile and the live V rows go out as cp.async groups
//   at the start, into resident tiles unpadded and chunk-swizzled; S of
//   tile j starts as soon as K tile j has landed, and V lands during the
//   S pass and the softmax. It stays within the footprint the policy
//   charges for the CUDA-core form, so the policy's resident threshold
//   and routes do not move.
#include "mma.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int MAXR_S = 16;   // score rows per thread: blk_q / 4 <= 16
constexpr int MAXR_PV = 8;   // output rows per thread: blk_q*E/1024 <= 8

struct Layout {
  int c, rg_s, nr_s;          // S tile: column, first row, row count
  int ce, rg_pv, rstep_pv, nr_pv;  // P V: 4 columns at ce, rows
};

__device__ __forceinline__ Layout thread_layout(int blk_q, int E) {
  Layout L;
  const int t = threadIdx.x;
  L.c = t % KV_TILE;
  L.rg_s = t / KV_TILE;                         // rows rg, rg+4, ...
  L.nr_s = blk_q > L.rg_s ? (blk_q - L.rg_s + 3) / 4 : 0;
  const int cpr = E / 4;                        // threads per output row
  L.ce = (t % cpr) * 4;
  L.rg_pv = t / cpr;
  L.rstep_pv = THREADS / cpr;
  L.nr_pv = blk_q > L.rg_pv ? (blk_q - L.rg_pv + L.rstep_pv - 1) / L.rstep_pv : 0;
  return L;
}

// S tile j of the score row: scale, three-band causal mask, kv tail.
template <typename T>
__device__ __forceinline__ void score_tile(float* S, int lds, const float* Qs,
                                           const T* Kt, int E, int j,
                                           int n_full, int q0, int causal,
                                           int kv_len, float sm_scale,
                                           const Layout& L) {
  float acc[MAXR_S];
  qk_dots<MAXR_S>(acc, Qs, Kt + L.c * (E + KV_ROW_PAD), E, L.nr_s, L.rg_s, 4);
  const int col = j * KV_TILE + L.c;
  const bool straddles = causal && j >= n_full;
#pragma unroll
  for (int i = 0; i < MAXR_S; ++i) {
    if (i < L.nr_s) {
      const int r = L.rg_s + 4 * i;
      float s = acc[i] * sm_scale;
      if (straddles && col > q0 + r) s = NEG_INF;
      if (col >= kv_len) s = NEG_INF;
      S[r * lds + col] = s;
    }
  }
}

// Exact softmax of each score row over its live columns [0, n_live),
// one warp per row, written back in place as P = exp(s - m) / l.
__device__ __forceinline__ void softmax_rows(float* S, int lds, int blk_q,
                                             int n_live) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < blk_q; r += THREADS / 32) {
    float* row = S + r * lds;
    float m = NEG_INF;
    for (int c = lane; c < n_live; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < n_live; c += 32) {
      const float p = expf(row[c] - m);
      row[c] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int c = lane; c < n_live; c += 32) row[c] = row[c] / l;
  }
}

template <typename T>
__device__ __forceinline__ void write_out(T* ob, const float (&acc)[MAXR_PV][4],
                                          int E, const Layout& L) {
#pragma unroll
  for (int i = 0; i < MAXR_PV; ++i) {
    if (i < L.nr_pv) {
      T* dst = ob + (size_t)(L.rg_pv + i * L.rstep_pv) * E + L.ce;
      store(dst + 0, acc[i][0]);
      store(dst + 1, acc[i][1]);
      store(dst + 2, acc[i][2]);
      store(dst + 3, acc[i][3]);
    }
  }
}

struct Bands {
  int n_full, n_needed;
};

__device__ __forceinline__ Bands causal_tile_bounds(int q0, int blk_q, int nkv_t,
                                                    int causal) {
  Bands b{nkv_t, nkv_t};
  if (causal) {
    b.n_full = min((q0 + 1) / KV_TILE, nkv_t);
    b.n_needed = min((q0 + blk_q - 1) / KV_TILE + 1, nkv_t);
  }
  return b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mas_resident_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int nq, int nkv,
                    int E, int group, int blk_q, int causal, int kv_len,
                    float sm_scale) {
  const int q0 = blockIdx.x * blk_q, bh = blockIdx.y;
  const Bands b = causal_tile_bounds(q0, blk_q, nkv / KV_TILE, causal);
  const int n_live = b.n_needed * KV_TILE;
  const Layout L = thread_layout(blk_q, E);

  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);          // (blk_q, nkv)
  float* Qs = S + blk_q * nkv;                         // (blk_q, E)
  T* Ks = reinterpret_cast<T*>(Qs + blk_q * E);        // (nkv, E + pad)
  T* Vs = Ks + nkv * (E + KV_ROW_PAD);

  const size_t kv_off = (size_t)(bh / group) * nkv * E;
  stage_q(Qs, q + ((size_t)bh * nq + q0) * E, blk_q, E);
  stage_rows(Ks, k + kv_off, n_live, n_live, E);
  stage_rows(Vs, v + kv_off, n_live, n_live, E);
  __syncthreads();

  // Alg. 2: S tiles into the full on-chip row (dead tiles skipped).
  for (int j = 0; j < b.n_needed; ++j) {
    score_tile(S, nkv, Qs, Ks + j * KV_TILE * (E + KV_ROW_PAD), E, j, b.n_full,
               q0, causal, kv_len, sm_scale, L);
  }
  __syncthreads();
  // Alg. 3: one exact row softmax over the live columns.
  softmax_rows(S, nkv, blk_q, n_live);
  __syncthreads();
  // Alg. 4: P V over the live V rows, resident in shared memory.
  float acc[MAXR_PV][4];
  pv_sums<MAXR_PV>(acc, S, nkv, Vs, n_live, E, L.ce, L.nr_pv, L.rg_pv,
                   L.rstep_pv);
  write_out(o + ((size_t)bh * nq + q0) * E, acc, E, L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mas_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int nq, int nkv,
                    int E, int group, int blk_q, int causal, int kv_len,
                    float sm_scale) {
  const int q0 = blockIdx.x * blk_q, bh = blockIdx.y;
  const Bands b = causal_tile_bounds(q0, blk_q, nkv / KV_TILE, causal);
  const int n_live = b.n_needed * KV_TILE;
  const Layout L = thread_layout(blk_q, E);

  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);          // (blk_q, nkv)
  float* Qs = S + blk_q * nkv;                         // (blk_q, E)
  T* Tb = reinterpret_cast<T*>(Qs + blk_q * E);        // one (KV_TILE, E + pad) tile

  const size_t kv_off = (size_t)(bh / group) * nkv * E;
  stage_q(Qs, q + ((size_t)bh * nq + q0) * E, blk_q, E);

  // S pass: each K tile overwrites the previous one in the buffer.
  for (int j = 0; j < b.n_needed; ++j) {
    __syncthreads();
    stage_rows(Tb, k + kv_off + (size_t)j * KV_TILE * E, KV_TILE, KV_TILE, E);
    __syncthreads();
    score_tile(S, nkv, Qs, Tb, E, j, b.n_full, q0, causal, kv_len, sm_scale, L);
  }
  __syncthreads();
  softmax_rows(S, nkv, blk_q, n_live);

  // P V pass: the V tiles are fetched again from device memory.
  float acc[MAXR_PV][4];
#pragma unroll
  for (int i = 0; i < MAXR_PV; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int j = 0; j < b.n_needed; ++j) {
    __syncthreads();
    stage_rows(Tb, v + kv_off + (size_t)j * KV_TILE * E, KV_TILE, KV_TILE, E);
    __syncthreads();
    float part[MAXR_PV][4];
    pv_sums<MAXR_PV>(part, S + j * KV_TILE, nkv, Tb, KV_TILE, E, L.ce, L.nr_pv,
                     L.rg_pv, L.rstep_pv);
#pragma unroll
    for (int i = 0; i < MAXR_PV; ++i) {
      acc[i][0] += part[i][0];
      acc[i][1] += part[i][1];
      acc[i][2] += part[i][2];
      acc[i][3] += part[i][3];
    }
  }
  write_out(o + ((size_t)bh * nq + q0) * E, acc, E, L);
}

// ---------------------------------------------------------------------------
// B2's bf16 form on the tensor cores.

constexpr int HALF = 32;   // K/V rows a half-tile buffer holds

// Column of score row `row` where logical column `col` is kept: the 8-float
// groups of a row are XOR-swizzled by row within each aligned 64 columns,
// so a row's live columns [0, n_live) stay the same set (the softmax reads
// them in place) and the fragment accesses of 8 rows fall on 32 banks.
__device__ __forceinline__ int scol(int row, int col) {
  return col ^ ((row & 7) << 3);
}

// One 32-column half tile h of the score row from the K rows staged at kt.
// Normal form: warp w computes the 8 columns 8 (w % 4) of m16 tile w / 4.
// Transposed form (blk_q 8): warps 0 and 1 compute S^T for 16 K rows each.
// Scores are kept in base 2 (scaled by log2 e), and each thread keeps the
// running maximum of its two rows (normal form: rows g, g + 8; transposed:
// Q rows 2 t4, 2 t4 + 1).
template <int E, int MT, bool TRANS>
__device__ __forceinline__ void score_half(float* S, int lds,
                                           const uint32_t (&qf)[E / 16][4],
                                           uint32_t kt, int h, int n_full,
                                           int q0, int blk_q, int causal,
                                           int kv_len, float scale_log2,
                                           float (&rmax)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool straddles = causal && h / 2 >= n_full;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (!TRANS) {
    const int nb = warp % 4, mt = warp / 4;
    if (mt >= MT) return;
#pragma unroll
    for (int ks = 0; ks < E / 16; ks += 2) {
      uint32_t r[4];
      tc::ldsm_x4(r, kt + tc::swz<E>(nb * 8 + lane % 8, ks * 16 + lane / 8 * 8));
      tc::mma(acc, qf[ks], r[0], r[1]);
      tc::mma(acc, qf[ks + 1], r[2], r[3]);
    }
    const int col = h * HALF + nb * 8 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {        // rows g and g + 8 of the m16 tile
      const int r = mt * 16 + g + 8 * i;
      if (r >= blk_q) continue;
      float s0 = acc[2 * i] * scale_log2, s1 = acc[2 * i + 1] * scale_log2;
      if (straddles && col > q0 + r) s0 = NEG_INF;
      if (straddles && col + 1 > q0 + r) s1 = NEG_INF;
      if (col >= kv_len) s0 = NEG_INF;
      if (col + 1 >= kv_len) s1 = NEG_INF;
      rmax[i] = fmaxf(rmax[i], fmaxf(s0, s1));
      *reinterpret_cast<float2*>(S + r * lds + scol(r, col)) =
          make_float2(s0, s1);
    }
  } else {
    if (warp >= HALF / 16) return;
#pragma unroll
    for (int ks = 0; ks < E / 16; ++ks) {
      uint32_t a[4];
      tc::ldsm_x4(a, kt + tc::swz<E>(warp * 16 + lane % 16, ks * 16 + lane / 16 * 8));
      tc::mma(acc, a, qf[ks][0], qf[ks][1]);
    }
    // acc: K rows warp * 16 + g (+ 8) by Q rows 2 t4, 2 t4 + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = h * HALF + warp * 16 + g + 8 * (i / 2);
      const int r = 2 * t4 + i % 2;
      float s = acc[i] * scale_log2;
      if ((straddles && col > q0 + r) || col >= kv_len) s = NEG_INF;
      rmax[i % 2] = fmaxf(rmax[i % 2], s);
      S[r * lds + scol(r, col)] = s;
    }
  }
}

// acc += P V for half tile h: P (fp32 in the row) as bf16 hi + lo, V rows
// staged at vt. Normal form: warp w owns output columns [w E/8, (w+1) E/8)
// of every m16 tile. Transposed form: warp w owns O^T rows [16 w, 16 w + 16).
template <int E, int MT, bool TRANS>
__device__ __forceinline__ void pv_half(float (&acc)[MT][E / 64][4],
                                        const float* S, int lds, uint32_t vt,
                                        int h, int blk_q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c0 = h * HALF;
  if (!TRANS) {
    uint32_t ph[MT][2][4], pl[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // A fragment: rows +8 (i % 2), cols +8 (i / 2)
          const int r = mt * 16 + g + 8 * (i % 2);
          const int col = c0 + kk * 16 + 8 * (i / 2) + 2 * t4;
          float2 p = make_float2(0.f, 0.f);
          if (r < blk_q) p = *reinterpret_cast<const float2*>(S + r * lds + scol(r, col));
          tc::split(p.x, p.y, ph[mt][kk][i], pl[mt][kk][i]);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < E / 64; ++nb) {
      uint32_t b[4];   // V rows 0-15 (b[0], b[1]) and 16-31 (b[2], b[3])
      tc::ldsm_x4_t(b, vt + tc::swz<E>(lane, warp * (E / 8) + nb * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        tc::mma(acc[mt][nb], ph[mt][0], b[0], b[1]);
        tc::mma(acc[mt][nb], pl[mt][0], b[0], b[1]);
        tc::mma(acc[mt][nb], ph[mt][1], b[2], b[3]);
        tc::mma(acc[mt][nb], pl[mt][1], b[2], b[3]);
      }
    }
  } else {
    if (warp >= E / 16) return;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];   // V^T rows warp * 16 .. + 15, V rows kk * 16 .. + 15
      tc::ldsm_x4_t(a, vt + tc::swz<E>(kk * 16 + lane % 8 + lane / 16 * 8,
                                       warp * 16 + lane / 8 % 2 * 8));
      const int col = c0 + kk * 16 + 2 * t4;
      const float2 p0 = *reinterpret_cast<const float2*>(S + g * lds + scol(g, col));
      const float2 p1 = *reinterpret_cast<const float2*>(S + g * lds + scol(g, col + 8));
      uint32_t h0, l0, h1, l1;
      tc::split(p0.x, p0.y, h0, l0);
      tc::split(p1.x, p1.y, h1, l1);
      tc::mma(acc[0][0], a, h0, h1);
      tc::mma(acc[0][0], a, l0, l1);
    }
  }
}

// Alg. 3 in bf16: each row's maximum from the S pass's partial maxima
// (red: NP a row), P = exp2(s - m) in place over the live columns, and the
// row sum l kept for the output (O = (P V) / l), one warp a row.
template <int NP>
__device__ __forceinline__ void softmax_exp_rows(float* S, int lds, int blk_q,
                                                 int n_live, const float* red,
                                                 float* lrow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < blk_q; r += THREADS / 32) {
    float* row = S + r * lds;
    float m = red[r * 4];
#pragma unroll
    for (int i = 1; i < NP; ++i) m = fmaxf(m, red[r * 4 + i]);
    float l = 0.f;
    for (int c = lane; c < n_live; c += 32) {
      const float p = exp2f(row[c] - m);
      row[c] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) lrow[r] = l;
  }
}

// B1's bf16 steps around its products. B2's kernel holds the same steps
// inline: moved into these helpers, its compiled form ran slower on an
// H100 (chip_smoke.py's mas_streamed row).

// Q in registers from the swizzled Q block at s_base: A fragments of
// S = Q K^T (rows past blk_q read the last row; their scores are never
// stored), or, transposed, B fragments of S^T.
template <int E, int MT, bool TRANS>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[E / 16][4],
                                             uint32_t s_base, int blk_q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < E / 16; ks += 2) {
    if (TRANS) {
      uint32_t r[4];
      tc::ldsm_x4(r, s_base + tc::swz<E>(lane % 8, ks * 16 + lane / 8 * 8));
      qf[ks][0] = r[0];
      qf[ks][1] = r[1];
      qf[ks + 1][0] = r[2];
      qf[ks + 1][1] = r[3];
    } else {
      const int row = min(min(warp / 4, MT - 1) * 16 + lane % 16, blk_q - 1);
      tc::ldsm_x4(qf[ks], s_base + tc::swz<E>(row, ks * 16 + lane / 16 * 8));
      tc::ldsm_x4(qf[ks + 1], s_base + tc::swz<E>(row, ks * 16 + 16 + lane / 16 * 8));
    }
  }
}

// Each row's maximum over a thread's quad (normal form) or the 8 lanes
// that share its Q rows (transposed form), one partial a warp, into red.
template <int MT, bool TRANS>
__device__ __forceinline__ void row_max_partials(const float (&rmax)[2],
                                                 float* red, int blk_q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  if (!TRANS && warp / 4 < MT) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int r = warp / 4 * 16 + g + 8 * i;
      if (t4 == 0 && r < blk_q) red[r * 4 + warp % 4] = m;
    }
  } else if (TRANS && warp < HALF / 16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = rmax[i];
      for (int lanes = 4; lanes < 32; lanes <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, lanes));
      if (g == 0) red[(2 * t4 + i) * 4 + warp] = m;
    }
  }
}

// The block's output rows O / l as bf16 at ob, from pv_half's
// accumulators and the rows' sums.
template <int E, int MT, bool TRANS>
__device__ __forceinline__ void store_out(__nv_bfloat16* ob,
                                          const float (&acc)[MT][E / 64][4],
                                          const float* lrow, int blk_q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  if (TRANS) {
    if (warp < E / 16) {   // acc: O^T rows warp * 16 + g (+ 8), Q rows 2 t4 (+ 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = warp * 16 + g + 8 * (i / 2), r = 2 * t4 + i % 2;
        ob[r * E + e] = __float2bfloat16(acc[0][0][i] / lrow[r]);
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < E / 64; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = mt * 16 + g + 8 * i;
          if (r >= blk_q) continue;
          const int col = warp * (E / 8) + nb * 8 + 2 * t4;
          const float l = lrow[r];
          *reinterpret_cast<__nv_bfloat162*>(ob + r * E + col) =
              __floats2bfloat162_rn(acc[mt][nb][2 * i] / l, acc[mt][nb][2 * i + 1] / l);
        }
  }
}

// B2 in bf16. Shared memory: the score row (first 4 blk_q nkv bytes), two
// half-tile buffers, the rows' partial maxima and sums. MT m16 tiles cover
// blk_q (16: 1, 24 or 32: 2); TRANS is the blk_q 8 form. K and V stream as
// one sequence of 2 nh half tiles, t < nh the K half t, t >= nh the V half
// t - nh: half t is stored from registers into buffer t % 2 (last read two
// steps before) while the loads of half t + 2 go out, so two half tiles
// are in flight while one is multiplied.
template <int E, int MT, bool TRANS>
__global__ void __launch_bounds__(THREADS)
mas_streamed_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int nq, int nkv,
                         int group, int blk_q, int causal, int kv_len,
                         float scale_log2) {
  constexpr int SLOT = HALF * E * 2;            // bytes of one buffer
  constexpr int CH = HALF * E / 8 / THREADS;    // 16-byte chunks a thread
  // the last Q blocks have the most live tiles: they go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * blk_q, bh = blockIdx.y;
  const Bands b = causal_tile_bounds(q0, blk_q, nkv / KV_TILE, causal);
  const int n_live = b.n_needed * KV_TILE;
  const int nh = 2 * b.n_needed;       // live half tiles, an even count
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);          // (blk_q, nkv), swizzled
  const uint32_t s_base = tc::smem_addr(smem);
  const uint32_t buf0 = s_base + 4u * blk_q * nkv, buf1 = buf0 + SLOT;
  float* red = reinterpret_cast<float*>(smem + 4ull * blk_q * nkv + 2 * SLOT);
  float* lrow = red + 4 * blk_q;
  const size_t kv_off = (size_t)(bh / group) * nkv * E;
  auto half_src = [&](int t) {
    return t < nh ? k + kv_off + (size_t)t * HALF * E
                  : v + kv_off + (size_t)(t - nh) * HALF * E;
  };

  // The Q block, swizzled, at the head of the score row; half tiles 0 and
  // 1 into registers.
  tc::cp_rows<E>(s_base, q + ((size_t)bh * nq + q0) * E, blk_q, THREADS);
  tc::cp_async_commit();
  uint4 pre0[CH], pre1[CH];
  tc::ld_rows<E, CH>(pre0, half_src(0), THREADS);
  tc::ld_rows<E, CH>(pre1, half_src(1), THREADS);
  tc::cp_async_wait<0>();
  __syncthreads();
  // Q in registers: A fragments of S = Q K^T (rows past blk_q read the
  // last row; their scores are never stored), or B fragments of S^T.
  uint32_t qf[E / 16][4];
#pragma unroll
  for (int ks = 0; ks < E / 16; ks += 2) {
    if (TRANS) {
      uint32_t r[4];
      tc::ldsm_x4(r, s_base + tc::swz<E>(lane % 8, ks * 16 + lane / 8 * 8));
      qf[ks][0] = r[0];
      qf[ks][1] = r[1];
      qf[ks + 1][0] = r[2];
      qf[ks + 1][1] = r[3];
    } else {
      const int row = min(min(warp / 4, MT - 1) * 16 + lane % 16, blk_q - 1);
      tc::ldsm_x4(qf[ks], s_base + tc::swz<E>(row, ks * 16 + lane / 16 * 8));
      tc::ldsm_x4(qf[ks + 1], s_base + tc::swz<E>(row, ks * 16 + 16 + lane / 16 * 8));
    }
  }

  // Half tile t from registers into its buffer, the loads of half t + 2
  // out, one barrier (the first also orders the Q fragment reads before the
  // row is written).
  auto stage = [&](int t, uint4 (&pre)[CH], uint32_t buf) {
    tc::st_rows<E, CH>(buf, pre, THREADS);
    if (t + 2 < 2 * nh) tc::ld_rows<E, CH>(pre, half_src(t + 2), THREADS);
    __syncthreads();
  };

  // Alg. 2: S half tiles into the row.
  float rmax[2] = {NEG_INF, NEG_INF};
  for (int h = 0; h < nh; h += 2) {
    stage(h, pre0, buf0);
    score_half<E, MT, TRANS>(S, nkv, qf, buf0, h, b.n_full, q0, blk_q,
                             causal, kv_len, scale_log2, rmax);
    stage(h + 1, pre1, buf1);
    score_half<E, MT, TRANS>(S, nkv, qf, buf1, h + 1, b.n_full, q0, blk_q,
                             causal, kv_len, scale_log2, rmax);
  }
  // Each row's maximum over a thread's quad (normal form) or the 8 lanes
  // that share its Q rows (transposed form), one partial a warp.
  if (!TRANS && warp / 4 < MT) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int r = warp / 4 * 16 + g + 8 * i;
      if (t4 == 0 && r < blk_q) red[r * 4 + warp % 4] = m;
    }
  } else if (TRANS && warp < HALF / 16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = rmax[i];
      for (int lanes = 4; lanes < 32; lanes <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, lanes));
      if (g == 0) red[(2 * t4 + i) * 4 + warp] = m;
    }
  }
  __syncthreads();
  // Alg. 3: one exact row softmax over the live columns, on the CUDA cores,
  // while V half tiles 0 and 1 (from device memory again) are in flight.
  softmax_exp_rows<TRANS ? HALF / 16 : 4>(S, nkv, blk_q, n_live, red, lrow);

  // Alg. 4: P V over the live V half tiles.
  float acc[MT][E / 64][4] = {};
  for (int h = 0; h < nh; h += 2) {
    stage(nh + h, pre0, buf0);
    pv_half<E, MT, TRANS>(acc, S, nkv, buf0, h, blk_q);
    stage(nh + h + 1, pre1, buf1);
    pv_half<E, MT, TRANS>(acc, S, nkv, buf1, h + 1, blk_q);
  }

  __nv_bfloat16* ob = o + ((size_t)bh * nq + q0) * E;
  if (TRANS) {
    if (warp < E / 16) {   // acc: O^T rows warp * 16 + g (+ 8), Q rows 2 t4 (+ 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = warp * 16 + g + 8 * (i / 2), r = 2 * t4 + i % 2;
        ob[r * E + e] = __float2bfloat16(acc[0][0][i] / lrow[r]);
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < E / 64; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = mt * 16 + g + 8 * i;
          if (r >= blk_q) continue;
          const int col = warp * (E / 8) + nb * 8 + 2 * t4;
          const float l = lrow[r];
          *reinterpret_cast<__nv_bfloat162*>(ob + r * E + col) =
              __floats2bfloat162_rn(acc[mt][nb][2 * i] / l, acc[mt][nb][2 * i + 1] / l);
        }
  }
}

// B1 in bf16. Shared memory: the score row (first 4 blk_q nkv bytes, the
// Q block at its head until the S pass), then K and V resident (nkv rows
// each, unpadded and chunk-swizzled), then the rows' partial maxima and
// sums. The copies go out at once as cp.async groups: Q, each live K tile
// on its own, then all live V rows. S of tile j starts when group j has
// landed, and V arrives during the S pass and the softmax: the paper's
// two streams, overlapped.
template <int E, int MT, bool TRANS>
__global__ void __launch_bounds__(THREADS)
mas_resident_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int nq, int nkv,
                         int group, int blk_q, int causal, int kv_len,
                         float scale_log2) {
  constexpr int TILE = KV_TILE * E * 2;         // bytes of one K or V tile
  // the last Q blocks have the most live tiles: they go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * blk_q, bh = blockIdx.y;
  const Bands b = causal_tile_bounds(q0, blk_q, nkv / KV_TILE, causal);
  const int n_live = b.n_needed * KV_TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);          // (blk_q, nkv), swizzled
  const uint32_t s_base = tc::smem_addr(smem);
  const uint32_t ks0 = s_base + 4u * blk_q * nkv, vs0 = ks0 + nkv * E * 2;
  float* red = reinterpret_cast<float*>(smem + 4ull * blk_q * nkv + 4ull * nkv * E);
  float* lrow = red + 4 * blk_q;
  const size_t kv_off = (size_t)(bh / group) * nkv * E;

  tc::cp_rows<E>(s_base, q + ((size_t)bh * nq + q0) * E, blk_q, THREADS);
  tc::cp_async_commit();
  for (int j = 0; j < b.n_needed; ++j) {
    tc::cp_rows<E>(ks0 + j * TILE, k + kv_off + (size_t)j * KV_TILE * E,
                   KV_TILE, THREADS);
    tc::cp_async_commit();
  }
  tc::cp_rows<E>(vs0, v + kv_off, n_live, THREADS);
  tc::cp_async_commit();
  tc::cp_async_wait_n(b.n_needed + 1);   // Q has landed
  __syncthreads();
  uint32_t qf[E / 16][4];
  load_q_frags<E, MT, TRANS>(qf, s_base, blk_q);

  // Alg. 2: S tile j into the row once K tile j has landed (the first
  // barrier also orders the Q fragment reads before the row is written).
  float rmax[2] = {NEG_INF, NEG_INF};
  for (int j = 0; j < b.n_needed; ++j) {
    tc::cp_async_wait_n(b.n_needed - j);
    __syncthreads();
    score_half<E, MT, TRANS>(S, nkv, qf, ks0 + j * TILE, 2 * j, b.n_full, q0,
                             blk_q, causal, kv_len, scale_log2, rmax);
    score_half<E, MT, TRANS>(S, nkv, qf, ks0 + j * TILE + TILE / 2, 2 * j + 1,
                             b.n_full, q0, blk_q, causal, kv_len, scale_log2,
                             rmax);
  }
  row_max_partials<MT, TRANS>(rmax, red, blk_q);
  __syncthreads();
  // Alg. 3: one exact row softmax over the live columns while V lands.
  softmax_exp_rows<TRANS ? HALF / 16 : 4>(S, nkv, blk_q, n_live, red, lrow);
  tc::cp_async_wait<0>();
  __syncthreads();

  // Alg. 4: P V over the live V rows, resident in shared memory.
  float acc[MT][E / 64][4] = {};
  for (int h = 0; h < 2 * b.n_needed; ++h)
    pv_half<E, MT, TRANS>(acc, S, nkv, vs0 + h * (TILE / 2), h, blk_q);
  store_out<E, MT, TRANS>(o + ((size_t)bh * nq + q0) * E, acc, lrow, blk_q);
}

size_t mas_smem_bytes(int blk_q, int nkv, int E, int itemsize, bool resident) {
  const size_t row = (size_t)(E + KV_ROW_PAD) * itemsize;
  size_t bytes = 4ull * blk_q * nkv + 4ull * blk_q * E;
  bytes += resident ? 2ull * nkv * row : (size_t)KV_TILE * row;
  return bytes;
}

// The CUDA-core kernels, fp32 only: B1 and B2.
template <typename Kernel>
int launch_cuda_core(Kernel kernel, bool resident, const void* q,
                     const void* k, const void* v, void* o, int bhq, int nq,
                     int nkv, int E, int group, int blk_q, int causal,
                     int kv_len, float sm_scale, cudaStream_t stream) {
  const size_t smem = mas_smem_bytes(blk_q, nkv, E, sizeof(float), resident);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / blk_q, bhq);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), nq, nkv, E, group,
      blk_q, causal, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

// The tensor-core kernels: B1 (RESIDENT) and B2 in bf16. Both stay within
// the policy's footprint: B2 takes it whole (its two half-tile buffers fit
// the Q block's fp32 region plus the padded tile buffer); B1 takes the
// score row, K and V unpadded, and the rows' maxima and sums (20 blk_q
// bytes, within the Q block's fp32 region it does not need).
template <bool RESIDENT, int E, int MT, bool TRANS>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bhq,
                int nq, int nkv, int group, int blk_q, int causal, int kv_len,
                float sm_scale, cudaStream_t stream) {
  auto kernel = RESIDENT ? mas_resident_bf16_kernel<E, MT, TRANS>
                         : mas_streamed_bf16_kernel<E, MT, TRANS>;
  const size_t smem =
      RESIDENT ? 4ull * blk_q * nkv + 4ull * nkv * E + 20ull * blk_q
               : mas_smem_bytes(blk_q, nkv, E, 2, false);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / blk_q, bhq);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      nq, nkv, group, blk_q, causal, kv_len, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <bool RESIDENT, int E>
int bf16_for_blk_q(const void* q, const void* k, const void* v, void* o,
                   int bhq, int nq, int nkv, int group, int blk_q, int causal,
                   int kv_len, float sm_scale, cudaStream_t s) {
  switch (blk_q) {
    case 8:
      return launch_bf16<RESIDENT, E, 1, true>(q, k, v, o, bhq, nq, nkv, group,
                                               blk_q, causal, kv_len, sm_scale, s);
    case 16:
      return launch_bf16<RESIDENT, E, 1, false>(q, k, v, o, bhq, nq, nkv, group,
                                                blk_q, causal, kv_len, sm_scale, s);
    case 24:
    case 32:
      return launch_bf16<RESIDENT, E, 2, false>(q, k, v, o, bhq, nq, nkv, group,
                                                blk_q, causal, kv_len, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool RESIDENT>
int bf16_launch(const void* q, const void* k, const void* v, void* o, int bhq,
                int nq, int nkv, int E, int group, int blk_q, int causal,
                int kv_len, float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E == 128)
    return bf16_for_blk_q<RESIDENT, 128>(q, k, v, o, bhq, nq, nkv, group, blk_q,
                                         causal, kv_len, sm_scale, s);
  if (E == 64)
    return bf16_for_blk_q<RESIDENT, 64>(q, k, v, o, bhq, nq, nkv, group, blk_q,
                                        causal, kv_len, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (bhq, nq, E); k, v: (bhq / group, nkv, E); o: like q. Contiguous.
// nq % blk_q == 0, nkv % KV_TILE == 0.

// fp32, on the CUDA cores: B1 and B2.
extern "C" int mas_resident_fp32_launch(const void* q, const void* k,
                                        const void* v, void* o, int bhq,
                                        int nq, int nkv, int E, int group,
                                        int blk_q, int causal, int kv_len,
                                        float sm_scale, void* stream) {
  return launch_cuda_core(mas_resident_kernel<float>, true, q, k, v, o, bhq,
                          nq, nkv, E, group, blk_q, causal, kv_len, sm_scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int mas_streamed_fp32_launch(const void* q, const void* k,
                                        const void* v, void* o, int bhq,
                                        int nq, int nkv, int E, int group,
                                        int blk_q, int causal, int kv_len,
                                        float sm_scale, void* stream) {
  return launch_cuda_core(mas_streamed_kernel<float>, false, q, k, v, o, bhq,
                          nq, nkv, E, group, blk_q, causal, kv_len, sm_scale,
                          static_cast<cudaStream_t>(stream));
}

// bf16, on the tensor cores: B1 and B2, E 64 or 128; blk_q 8, 16, 24 or
// 32; q, k and v 16-byte aligned.
extern "C" int mas_resident_bf16_launch(const void* q, const void* k,
                                        const void* v, void* o, int bhq,
                                        int nq, int nkv, int E, int group,
                                        int blk_q, int causal, int kv_len,
                                        float sm_scale, void* stream) {
  return bf16_launch<true>(q, k, v, o, bhq, nq, nkv, E, group, blk_q, causal,
                           kv_len, sm_scale, stream);
}

extern "C" int mas_streamed_bf16_launch(const void* q, const void* k,
                                        const void* v, void* o, int bhq,
                                        int nq, int nkv, int E, int group,
                                        int blk_q, int causal, int kv_len,
                                        float sm_scale, void* stream) {
  return bf16_launch<false>(q, k, v, o, bhq, nq, nkv, E, group, blk_q, causal,
                            kv_len, sm_scale, stream);
}
