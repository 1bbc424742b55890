// Split-KV attention of a few query rows on the tensor cores: the pass-1
// block and the merge pass shared by the bf16-query forms of B4 (dense
// decode, bf16 and int8 caches, decode_attention.cu), B6 (paged decode,
// bf16 and int8 pools, paged_decode_attention.cu) and B7 (paged verify,
// bf16 and int8 pools, paged_verify_attention.cu).
//
// For one (b, kv head), R query rows (the G heads of a GQA group, or for
// B7 k positions of them, position-major) attend to the logical KV rows
// below kv_len. Dense rows and paged rows differ only in the functor that
// gives a logical row's offset and the index of its int8 scale
// (DenseRows, PagedRows of common.cuh).
//
// What bounds it on an H100: each live K and V row is read once for all R
// rows, G/2 (B4, B6) or k G/2 (B7) multiply-adds a byte, far below the ~295
// operations a byte where the tensor cores would become the limit, so the
// floor is device-memory bandwidth and the time goes to bytes in flight
// and to the number of blocks that share the longest sequence. The design:
// - Short splits (decode_split_plan in decode_attention.py: 1-4 tiles of
//   64 rows a block), so the longest sequence of a ragged batch spreads
//   over every SM. Blocks wholly past kv_len exit after reading it and
//   write nothing: the merge stops at the live splits.
// - Each of the block's four warps owns the 16-row slices warp, warp + 4,
//   ... of its split, and stages them itself: a ring of STAGES (K, V)
//   slots a warp, filled by cp.async 16 bytes a lane (rows at or past
//   kv_len zero-filled, never read), STAGES - 1 slices in flight while
//   one is multiplied. A warp waits only on its own copies, so the tile
//   loop has no __syncthreads; each warp keeps its own online softmax and
//   the block merges the warps' (m, l, acc) once, at the end. A paged
//   16-row slice is one page of the pool (4 KB of K and 4 KB of V at E
//   128); a dense one 16 contiguous rows.
// - S = Q K^T and P V by mma.sync m16n8k16 (mma.cuh). The R query rows
//   are the A operand padded to 16 (MT m16 tiles, rows past R zero); K
//   and V come by ldmatrix (.trans for V) from chunk-swizzled slots. S is
//   scaled to base 2, masked and exponentiated in registers and is P's A
//   fragment directly, entering P V as bf16 hi + lo (tc::split): one bf16
//   rounding of P is about the whole 4e-3 row limit.
// - int8 K/V (KV = int8_t: B6's and B7's pools with per-page fp32
//   scales, B4's dense caches with per-row ones) keep their ring slots
//   raw: a slice's int8 K and V rows by cp.async, 16 bytes a lane, and its
//   16 K and 16 V scales, 4 bytes a lane, each at the index the row
//   functor gives (Rows::scale: a row's page through the table, or a dense
//   row itself). When the slice's copies have landed, each lane
//   converts the chunks it copied itself to bf16 (exact: every int8 value
//   has 8 significant bits) into the warp's own swizzled bf16 slot, which
//   ldmatrix reads as for a bf16 pool; a __syncwarp, no block barrier. The
//   K scale multiplies each score column after scale_log2 and before the
//   row max; the V scale multiplies P after the row sum and before the
//   hi + lo split, as the plain version and the TPU kernel order them.
// - Masks in three bands, as B5 and the CUDA-core forms: a slice wholly
//   below min(q0 + 1, kv_len) (B4: kv_len) is unmasked; later live slices
//   take the select col < kv_len && col <= q0 + r / rows_per_pos (B4: the
//   kv tail only); slices at or past kv_len are never loaded.
// Partials are kept in base 2 (m scaled by log2 e) and merged only here.
#pragma once

#include "mma.cuh"

namespace repro {
namespace dtc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STEP = 16;       // kv rows of one warp step (one A/B k16 block)
constexpr int STAGES = 3;      // ring slots a warp
constexpr int MERGE_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int E, int MT>
__host__ __device__ constexpr int q_bytes() { return MT * 16 * E * 2; }
// A ring slot: a slice's K and V rows in bf16, or for int8 K/V (Q8) its
// raw int8 rows and then its 16 K and 16 V scales.
template <int E, bool Q8 = false>
__host__ __device__ constexpr int slot_bytes() {
  return Q8 ? 2 * STEP * E + 2 * STEP * 4 : 2 * STEP * E * 2;
}
template <int E, bool Q8 = false>
__host__ __device__ constexpr int ring_bytes() {
  return WARPS * STAGES * slot_bytes<E, Q8>();
}
// int8 K/V: each warp's bf16 slot, the slice it multiplies, converted.
template <int E, bool Q8 = false>
__host__ __device__ constexpr int conv_bytes() {
  return Q8 ? WARPS * slot_bytes<E>() : 0;
}
// Dynamic shared memory of a pass-1 block: the Q block, the warps' rings
// and bf16 slots (reused by the warps' merge), each warp's row maxima and
// sums.
template <int E, int MT, bool Q8 = false>
__host__ __device__ constexpr int smem_bytes() {
  return q_bytes<E, MT>() + ring_bytes<E, Q8>() + conv_bytes<E, Q8>() +
         2 * WARPS * MT * 16 * 4;
}

// Four fp32 values stored as bf16 at p (8-byte aligned).
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  memcpy(&u.x, &a, 4);
  memcpy(&u.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [pos0, pos0 + STEP) of K and V into a ring slot (K, then V, each
// 16 rows of E, chunk-swizzled), 16 bytes a lane by cp.async.
template <int E, typename Rows>
__device__ __forceinline__ void issue_step(uint32_t slot, const bf16* k,
                                           const bf16* v, const Rows& rows,
                                           int pos0, int kv_len, int lane) {
  constexpr int CH = E / 8;                // 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < STEP * CH / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH, c = i % CH;
    const bool live = pos0 + r < kv_len;
    const size_t off = live ? rows(pos0 + r) + c * 8 : 0;
    const uint32_t dst = slot + tc::swz<E>(r, c * 8);
    tc::cp_async16_zfill(dst, k + off, live ? 16 : 0);
    tc::cp_async16_zfill(dst + STEP * E * 2, v + off, live ? 16 : 0);
  }
}

// int8 rows [pos0, pos0 + STEP) into a raw ring slot: K, then V, each 16
// rows of E bytes (chunk i of the slice at byte 16 i), 16 bytes a lane by
// cp.async; then the rows' scales, K's from lanes 0-15 and V's from lanes
// 16-31, 4 bytes a lane, at ks[rows.scale(pos)], vs[rows.scale(pos)]:
// ks, vs the kv head's row of the (Hkv, P) page scales (PagedRows) or the
// (b, kv head)'s row of the (BH, S) row scales (DenseRows). Rows at or
// past kv_len are zero-filled.
template <int E, typename Rows>
__device__ __forceinline__ void issue_step_q8(uint32_t slot, const int8_t* k,
                                              const int8_t* v,
                                              const float* ks,
                                              const float* vs,
                                              const Rows& rows, int pos0,
                                              int kv_len, int lane) {
  constexpr int CH = E / 16;               // 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < STEP * CH / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH, c = i % CH;
    const bool live = pos0 + r < kv_len;
    const size_t off = live ? rows(pos0 + r) + c * 16 : 0;
    tc::cp_async16_zfill(slot + i * 16, k + off, live ? 16 : 0);
    tc::cp_async16_zfill(slot + STEP * E + i * 16, v + off, live ? 16 : 0);
  }
  const int r = lane % STEP;
  const bool live = pos0 + r < kv_len;
  const int idx = live ? rows.scale(pos0 + r) : 0;
  tc::cp_async4_zfill(slot + 2 * STEP * E + lane * 4,
                      (lane < STEP ? ks : vs) + idx, live ? 4 : 0);
}

// Four int8 values (a word) as four bf16 values (two words, the lower
// column in the low half). Exact: 2^23 + 128 + x is an fp32 integer, the
// subtraction leaves x, and an x of at most 8 significant bits has the
// upper half of its fp32 as its bf16.
__device__ __forceinline__ uint2 q8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;      // x + 128 a byte, unsigned
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) -
        8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

// The chunks of a raw int8 slot that this lane copied (issue_step_q8's),
// as bf16 into the warp's swizzled slot conv (K, then V, as issue_step
// lays out a bf16 pool's slice). A lane reads only its own copies, which
// its cp_async_wait has landed.
template <int E>
__device__ __forceinline__ void convert_step(uint32_t conv, uint32_t slot,
                                             int lane) {
  constexpr int CH = E / 16;
#pragma unroll
  for (int j = 0; j < STEP * CH / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH, c = i % CH;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      uint4 u;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                   : "r"(slot + kv * STEP * E + i * 16));
      const uint2 b0 = q8x4_bf16(u.x), b1 = q8x4_bf16(u.y);
      const uint2 b2 = q8x4_bf16(u.z), b3 = q8x4_bf16(u.w);
      const uint32_t dst = conv + kv * STEP * E * 2;
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       dst + tc::swz<E>(r, c * 16)),
                   "r"(b0.x), "r"(b0.y), "r"(b1.x), "r"(b1.y)
                   : "memory");
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       dst + tc::swz<E>(r, c * 16 + 8)),
                   "r"(b2.x), "r"(b2.y), "r"(b3.x), "r"(b3.y)
                   : "memory");
    }
  }
}

// Pass 1 of one block: the split of logical rows [row0, row0 + tiles *
// 64) of one (b, kv head), whose R query rows start at q and whose K and V
// rows sit at k + rows(pos), v + rows(pos), of type KV: bf16, or int8
// with ks, vs the scales that Rows::scale indexes (per page, or per dense
// row). Row r sits at position q0 + r / rows_per_pos (VERIFY;
// otherwise every row sees the live context). Writes the split's m (base
// 2), l and acc (R x E) for its R rows. row0 < kv_len.
template <int E, int MT, bool VERIFY, typename KV, typename Rows>
__device__ __forceinline__ void split_block(
    const bf16* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const Rows& rows, int kv_len, int q0, int R,
    int rows_per_pos, int row0, int tiles, float scale_log2,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, const float* __restrict__ ks = nullptr,
    const float* __restrict__ vs = nullptr) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  static_assert(Q8 || std::is_same<KV, bf16>::value, "bf16 or int8 K/V");
  static_assert(E == 64 || E == 128, "head dim 64 or 128");
  constexpr int LDO = E + 8;       // the warps' merge rows, fp32
  static_assert(WARPS * MT * 16 * LDO * 4 <=
                    ring_bytes<E, Q8>() + conv_bytes<E, Q8>(),
                "the warps' merge fits in the rings");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t qs = tc::smem_addr(smem);
  const uint32_t ring =
      qs + q_bytes<E, MT>() + warp * STAGES * slot_bytes<E, Q8>();
  // int8 K/V: the warp's bf16 slot
  const uint32_t conv =
      qs + q_bytes<E, MT>() + ring_bytes<E, Q8>() + warp * slot_bytes<E>();
  float* wm = reinterpret_cast<float*>(
      smem + q_bytes<E, MT>() + ring_bytes<E, Q8>() +
      conv_bytes<E, Q8>());                               // (WARPS, MT 16)
  float* wl = wm + WARPS * MT * 16;
  // slice pos0 into the ring slot at `slot`
  auto issue = [&](uint32_t slot, int pos0) {
    if constexpr (Q8)
      issue_step_q8<E>(slot, k, v, ks, vs, rows, pos0, kv_len, lane);
    else
      issue_step<E>(slot, k, v, rows, pos0, kv_len, lane);
  };

  // Q: rows [0, R), zero to MT * 16, one copy group ahead of the ring's
  {
    constexpr int CH = E / 8;
    for (int i = threadIdx.x; i < MT * 16 * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool live = r < R;
      tc::cp_async16_zfill(qs + tc::swz<E>(r, c * 8),
                           q + (live ? (size_t)r * E + c * 8 : 0),
                           live ? 16 : 0);
    }
    tc::cp_async_commit();
  }
  // this warp's live slices: first + i * WARPS * STEP for i < n
  const int first = row0 + warp * STEP;
  const int n = kv_len > first
                    ? min(tiles, (kv_len - first + WARPS * STEP - 1) /
                                     (WARPS * STEP))
                    : 0;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) issue(ring + i * slot_bytes<E, Q8>(), first + i * WARPS * STEP);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<STAGES - 1>();   // this thread's part of Q has landed
  __syncthreads();                   // ... and every thread's

  int rpos[MT][2];                   // positions of rows g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rpos[mt][h] = q0 + (mt * 16 + g + 8 * h) / rows_per_pos;
  // slices ending at or below this need no mask
  const int clear = VERIFY ? min(q0 + 1, kv_len) : kv_len;

  float acc[MT][E / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = NEG_INF;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < E / 8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nb][j] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    if (i + STAGES - 1 < n)
      issue(ring + (i + STAGES - 1) % STAGES * slot_bytes<E, Q8>(),
            first + (i + STAGES - 1) * WARPS * STEP);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();   // slice i has landed (this lane's)
    const uint32_t slot = ring + i % STAGES * slot_bytes<E, Q8>();
    if constexpr (Q8) convert_step<E>(conv, slot, lane);
    __syncwarp();                      // ... and the warp's
    const uint32_t kt = Q8 ? conv : slot;
    const uint32_t vt = kt + STEP * E * 2;
    const int c0 = first + i * WARPS * STEP;
    // int8: the slice's K scales, then its V scales
    const float* scales =
        reinterpret_cast<const float*>(smem + (slot - qs) + 2 * STEP * E);

    // S = Q K^T: s[mt][nb] holds kv rows nb * 8 + 2 t4 (+1) of rows g, g + 8
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[mt][0][j] = s[mt][1][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk) {
      uint32_t kb[4];   // kv rows 0-7 (kb[0], kb[1]) and 8-15 (kb[2], kb[3])
      tc::ldsm_x4(kb, kt + tc::swz<E>((lane & 7) + (lane >> 4 << 3),
                                      kk * 16 + (lane >> 3 & 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        tc::ldsm_x4(qa, qs + tc::swz<E>(mt * 16 + (lane & 15),
                                        kk * 16 + (lane >> 4) * 8));
        tc::mma(s[mt][0], qa, kb[0], kb[1]);
        tc::mma(s[mt][1], qa, kb[2], kb[3]);
      }
    }

    // online softmax in base 2; P as bf16 hi + lo A fragments
    const bool masked = c0 + STEP > clear;
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {     // row g (h 0) or g + 8 (h 1)
        float x[4];                      // kv rows 2 t4, 2 t4 + 1, +8, +9
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = c0 + nb * 8 + 2 * t4 + j;
            float val = s[mt][nb][2 * h + j] * scale_log2;
            if constexpr (Q8) val *= scales[nb * 8 + 2 * t4 + j];
            if (masked && (col >= kv_len || (VERIFY && col > rpos[mt][h])))
              val = NEG_INF;
            x[2 * nb + j] = val;
          }
        }
        float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][h], mx);
        const float alpha = exp2f(m[mt][h] - m_new);
        m[mt][h] = m_new;
        float p[4], psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = x[j] == NEG_INF ? 0.f : exp2f(x[j] - m_new);
          psum += p[j];
        }
        l[mt][h] = l[mt][h] * alpha + psum;
        if constexpr (Q8) {             // the V scales, after the row sum
#pragma unroll
          for (int j = 0; j < 4; ++j)
            p[j] *= scales[STEP + (j >> 1) * 8 + 2 * t4 + (j & 1)];
        }
#pragma unroll
        for (int nb = 0; nb < E / 8; ++nb) {
          acc[mt][nb][2 * h] *= alpha;
          acc[mt][nb][2 * h + 1] *= alpha;
        }
        // A fragment: register h holds k 0-7 of this row, h + 2 k 8-15
        tc::split(p[0], p[1], ph[mt][h], pl[mt][h]);
        tc::split(p[2], p[3], ph[mt][h + 2], pl[mt][h + 2]);
      }
    }

    // acc += P V: V's columns 16 cb .. 16 cb + 15 as two n8 blocks
#pragma unroll
    for (int cb = 0; cb < E / 16; ++cb) {
      uint32_t vb[4];
      tc::ldsm_x4_t(vb, vt + tc::swz<E>(lane & 15, cb * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        tc::mma(acc[mt][2 * cb], ph[mt], vb[0], vb[1]);
        tc::mma(acc[mt][2 * cb], pl[mt], vb[0], vb[1]);
        tc::mma(acc[mt][2 * cb + 1], ph[mt], vb[2], vb[3]);
        tc::mma(acc[mt][2 * cb + 1], pl[mt], vb[2], vb[3]);
      }
    }
    __syncwarp();                      // the slot may be refilled
  }
  tc::cp_async_wait<0>();

  // The block's merge of its warps, once: each warp's rows into the rings
  // (every warp is past its loop), then M = max m, L = sum l 2^(m - M),
  // acc = sum acc 2^(m - M) per row.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
    }
  __syncthreads();
  float* wo = reinterpret_cast<float*>(smem + q_bytes<E, MT>());
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r >= R) continue;
      if (t4 == 0) {
        wm[warp * MT * 16 + r] = m[mt][h];
        wl[warp * MT * 16 + r] = l[mt][h];
      }
      float* row = wo + ((size_t)warp * R + r) * LDO + 2 * t4;
#pragma unroll
      for (int nb = 0; nb < E / 8; ++nb)
        *reinterpret_cast<float2*>(row + nb * 8) =
            make_float2(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
    }
  __syncthreads();
  for (int it = threadIdx.x; it < R * (E / 4); it += THREADS) {
    const int r = it / (E / 4), c = it % (E / 4) * 4;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * MT * 16 + r]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(wm[w * MT * 16 + r] - mx);
      const float4 a = *reinterpret_cast<const float4*>(
          wo + ((size_t)w * R + r) * LDO + c);
      lsum = fmaf(wl[w * MT * 16 + r], wt, lsum);
      o.x = fmaf(a.x, wt, o.x);
      o.y = fmaf(a.y, wt, o.y);
      o.z = fmaf(a.z, wt, o.z);
      o.w = fmaf(a.w, wt, o.w);
    }
    *reinterpret_cast<float4*>(acc_out + (size_t)r * E + c) = o;
    if (c == 0) {
      m_out[r] = mx;
      l_out[r] = lsum;
    }
  }
}

// Pass 2 of one (b, kv head): merges the partials of its splits below
// kv_len (a split covers `span` rows; dead splits wrote nothing):
// M = max m, L = sum l 2^(m - M), O = sum acc 2^(m - M) / L, with kv_len 0
// giving zeros. Partials (n_split, R) and (n_split, R, E) from m, l, acc;
// o (R, E). When R E / 4 is below the block size, thread groups take
// interleaved splits and their sums are added in shared memory.
template <int E>
__device__ __forceinline__ void merge_splits(const float* __restrict__ m,
                                             const float* __restrict__ l,
                                             const float* __restrict__ acc,
                                             bf16* __restrict__ o, int kv_len,
                                             int R, int n_split, int span) {
  __shared__ float row_max[32], row_inv[32];
  __shared__ float4 red[MERGE_THREADS];
  const int n_live = min(n_split, (kv_len + span - 1) / span);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += MERGE_THREADS / 32) {
    float mx = NEG_INF;
    for (int s = lane; s < n_live; s += 32) mx = fmaxf(mx, m[s * R + r]);
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < n_live; s += 32)
      lsum = fmaf(l[s * R + r], exp2f(m[s * R + r] - mx), lsum);
    lsum = warp_sum(lsum);
    if (lane == 0) {
      row_max[r] = mx;
      row_inv[r] = lsum > 0.f ? 1.f / lsum : 0.f;
    }
  }
  __syncthreads();
  constexpr int C4 = E / 4;
  const int items = R * C4;
  const int groups = items >= MERGE_THREADS ? 1 : MERGE_THREADS / items;
  for (int it = threadIdx.x; it < items * groups; it += MERGE_THREADS) {
    const int grp = it / items, item = it % items;
    const int r = item / C4, c = item % C4 * 4;
    const float mx = row_max[r], inv = row_inv[r];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = grp; s < n_live; s += groups) {
      const float wt = exp2f(m[s * R + r] - mx) * inv;
      const float4 a = *reinterpret_cast<const float4*>(
          acc + ((size_t)s * R + r) * E + c);
      sum.x = fmaf(a.x, wt, sum.x);
      sum.y = fmaf(a.y, wt, sum.y);
      sum.z = fmaf(a.z, wt, sum.z);
      sum.w = fmaf(a.w, wt, sum.w);
    }
    if (groups == 1)
      store4(o + (size_t)r * E + c, sum);
    else
      red[it] = sum;
  }
  if (groups > 1) {
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += MERGE_THREADS) {
      float4 sum = red[it];
      for (int grp = 1; grp < groups; ++grp) {
        const float4 a = red[grp * items + it];
        sum.x += a.x;
        sum.y += a.y;
        sum.z += a.z;
        sum.w += a.w;
      }
      store4(o + (size_t)(it / C4) * E + it % C4 * 4, sum);
    }
  }
}

}  // namespace dtc
}  // namespace repro
