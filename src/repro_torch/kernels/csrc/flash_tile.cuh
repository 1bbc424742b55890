// The online-softmax tile step of the wgmma kernels: B3's bf16 form
// (flash_attention.cu) and B5's (paged_prefill_attention.cu).
//
// A warpgroup (4 warps of 16 rows) computes 64 query rows. Each
// thread holds its two rows' running max m and sum share l (rows g and
// g + 8 of its warp, g = lane / 4) and its share of the warpgroup's
// (64, EO) output accumulator: EO = E, or at E 256 one of two 128-column
// halves, each warpgroup of a two-warpgroup block (B3's E-256 form)
// computing S whole and its own half of O. One step takes one 64-row KV
// tile from shared memory:
// - S = Q K^T by wgmma m64n64k16, Q's A fragments in registers, the K tile
//   (K-major) read through its descriptor;
// - S scaled to base 2 (and, for an int8 pool, by each column's K scale),
//   masked in registers where the tile needs it;
// - the online max and sum over each row's quad of threads, the output
//   rescaled in registers;
// - P (times each column's V scale, for an int8 pool, after the row sum
//   and before the split) as bf16 hi + lo into O += P V by wgmma m64nEOk16,
//   the S accumulators reused as P V's A fragments, the V tile (MN-major)
//   read through its descriptor.
// K and V tiles are KV_TILE rows of E bf16 in the 128-byte-swizzled
// layout of mma.cuh (sw128<KV_TILE>), each 1024-byte aligned.
#pragma once

#include "mma.cuh"

namespace repro {
namespace tc {

// O (64 x E) += A (64 x 16) B (16 x E), B MN-major: the P V product (E
// here is the warpgroup's output columns, EO).
template <int E>
__device__ __forceinline__ void wgmma_pv(float (&d)[E / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(E == 64 || E == 128, "a warpgroup's P V is 64 or 128 wide");
  if constexpr (E == 64) {
    wgmma_m64n64k16<1>(d, a, b);
  } else {
    wgmma_m64n128k16<1>(d, a, b);
  }
}

// The warp's index in its warpgroup: where one warpgroup runs the tile
// steps (WGS 1: B5's consumer warps 0-3, B3 at E 64 and 128) simply
// threadIdx.x / 32, as the single-warpgroup code has always computed it;
// with two warpgroups (B3 at E 256) the warp's place in its own.
template <int WGS>
__device__ __forceinline__ int wg_warp() {
  return WGS == 1 ? threadIdx.x / 32 : threadIdx.x % 128 / 32;
}

// A warpgroup's online-softmax state for 64 query rows.
template <int E>
struct OnlineRows {
  float o[E / 2];   // output accumulators: n8 block nb, rows g / g + 8
  float m[2];       // running max (base 2) of rows g and g + 8
  float l[2];       // this thread's share of their running sums

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // Row sums over each quad; the sum of row g + 8 rr.
  __device__ __forceinline__ float row_sum(int rr) const {
    float s = l[rr];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    return s;
  }
};

// Q's A fragments for the block's 64 rows, from the sw128 Q tile at qs.
// The kernels load them for every tile rather than hold them across the
// tile loop: held, one of them was overwritten after the first tile at
// head dim 64 (in the SASS, the scaled scores' FMUL wrote R103, the last
// register of the fourth fragment, right after the first tile's S
// products), and every later tile's scores came out wrong. Loaded per
// tile, no operand of the products is carried from one tile to the next
// in registers.
template <int E, int WGS = 1>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[E / 16][4],
                                                 uint32_t qs) {
  const int warp = wg_warp<WGS>(), lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < E / 16; ++ks)
    ldsm_x4(qf[ks], qs + sw128<64>(warp * 16 + lane % 16, ks * 16 + lane / 16 * 8));
}

// One KV tile (K at kt, V's first of the warpgroup's EO columns at vt)
// into the state. keep(row, col): whether row `row` of the block sees
// column `col` of the tile, asked only when need_mask. SCALED (int8
// pools): ks, vs hold the tile's per-column K and V scales; otherwise they
// are not read.
template <int E, bool SCALED, int EO = E, typename Keep>
__device__ __forceinline__ void online_tile(OnlineRows<EO>& st,
                                            uint32_t (&qf)[E / 16][4],
                                            uint32_t kt, uint32_t vt,
                                            float scale_log2, bool need_mask,
                                            Keep keep, const float* ks,
                                            const float* vs) {
  const int warp = wg_warp<E / EO>(), lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < E / 16; ++k)
    wgmma_m64n64k16<0>(
        s, qf[k], gmma_desc(kt + (k / 4) * (KV_TILE * 128) + (k % 4) * 32, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(qf);

#pragma unroll
  for (int i = 0; i < 32; ++i) {   // n8 block i / 4: rows g (i % 4 < 2) and g + 8
    const int col = i / 4 * 8 + 2 * t4 + i % 2;
    float x = s[i] * scale_log2;
    if (SCALED) x *= ks[col];
    if (need_mask && !keep(warp * 16 + g + 8 * (i % 4 / 2), col)) x = NEG_INF;
    s[i] = x;
  }

  // Online max and sum (base 2), each row over its quad of threads.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < KV_TILE / 8; ++nb)
      mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * rr], s[4 * nb + 2 * rr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[rr], mx);
    const float alpha = exp2f(st.m[rr] - m_new);
    st.m[rr] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < KV_TILE / 8; ++nb) {
      s[4 * nb + 2 * rr] = exp2f(s[4 * nb + 2 * rr] - m_new);
      s[4 * nb + 2 * rr + 1] = exp2f(s[4 * nb + 2 * rr + 1] - m_new);
      sum += s[4 * nb + 2 * rr] + s[4 * nb + 2 * rr + 1];
    }
    st.l[rr] = st.l[rr] * alpha + sum;
#pragma unroll
    for (int nb = 0; nb < EO / 8; ++nb) {
      st.o[4 * nb + 2 * rr] *= alpha;
      st.o[4 * nb + 2 * rr + 1] *= alpha;
    }
  }
  if (SCALED) {   // the V scales fold into P after the row sum
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= vs[i / 4 * 8 + 2 * t4 + i % 2];
  }

  // O += P V: the S accumulators of columns 16 kk .. 16 kk + 15 are the A
  // fragment of k step kk, as bf16 hi + lo; V's 64-column halves are
  // KV_TILE * 128 bytes apart.
  uint32_t ph[KV_TILE / 16][4], pl[KV_TILE / 16][4];
#pragma unroll
  for (int kk = 0; kk < KV_TILE / 16; ++kk) {
    split(s[8 * kk + 0], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
    split(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
    split(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
    split(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
  }
  fence_regs(st.o);
  fence_regs(ph);
  fence_regs(pl);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KV_TILE / 16; ++kk) {
    const uint64_t dv = gmma_desc(vt + kk * 16 * 128, KV_TILE * 128, 1024);
    wgmma_pv<EO>(st.o, ph[kk], dv);
    wgmma_pv<EO>(st.o, pl[kk], dv);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st.o);
  fence_regs(ph);
  fence_regs(pl);
}

// The warpgroup's 64 output rows of E columns, O / l (l = 0, a row that
// saw no key, divides by 1), as bf16 at ob (row stride ld, E by default).
template <int E, int WGS = 1>
__device__ __forceinline__ void store_rows(const OnlineRows<E>& st,
                                           __nv_bfloat16* ob, int ld = E) {
  const int warp = wg_warp<WGS>(), lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lr = st.row_sum(rr);
    lr = lr == 0.f ? 1.f : lr;
    const int r = warp * 16 + g + 8 * rr;
#pragma unroll
    for (int nb = 0; nb < E / 8; ++nb) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * ld + nb * 8 + 2 * t4) =
          __floats2bfloat162_rn(st.o[4 * nb + 2 * rr] / lr, st.o[4 * nb + 2 * rr + 1] / lr);
    }
  }
}

}  // namespace tc
}  // namespace repro
