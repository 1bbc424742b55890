// Online-softmax attention for Hopper: kernel B3.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (flash_attention_flat; body _flash_kernel).
//
// What it computes: one thread block owns one (b*h, Q row block) and walks
// the KV tiles in order with an online max/sum, so its working set is one
// (blk_q, KV_TILE) tile instead of a full score row; this is what serves
// rows too long for the MAS row buffer and every sliding-window call.
// Whole tiles above the causal diagonal or outside the window are skipped
// (no load, no compute); only boundary tiles are masked (causal, window,
// kv_len tail). Query row i sits at absolute position q_offset + i. Rows
// that saw no key (l == 0) write zeros.
//
// The fp32 form (flash_attention_fp32_launch) runs its products on the
// CUDA cores in fp32: bound by instructions and latency, one block an SM.
//
// The bf16 form (flash_attention_bf16_launch, head dim 64, 128 or 256) is bound
// by its tensor-core products (the causal 1 x 8192 prefill is 275 GFLOP
// against 0.10 GB of inputs). Its design:
// - 64-row blocks of one warpgroup (4 warps of 16 rows), so each K/V
//   tile staged from L2 serves 64 rows (twice the fp32 form's 32); two
//   blocks an SM.
// - S = Q K^T and P V by wgmma (the tile step of flash_tile.cuh, shared
//   with B5): m64n64k16 for S with Q's A fragments in registers and K
//   (K-major) read by the tensor cores from shared memory through a
//   descriptor; m64nEk16 for P V with P's fragments in registers and V
//   (MN-major) through a descriptor. K/V tiles are kept in the
//   128-byte-swizzled layout the descriptors name.
// - S and P never leave registers: the max and sum run online over each
//   row's quad of threads by shuffles, the output is rescaled in
//   registers, and the S accumulators become the A fragments of P V
//   directly, as bf16 hi + lo. Q's A fragments are loaded from shared
//   memory for every tile (flash_tile.cuh says why).
// - K and V tiles are double-buffered by cp.async: tile j + 1 is copied
//   while tile j is multiplied.
//
// At head dim 256 (recurrentgemma-9b's windowed MQA layers) one
// warpgroup would hold Q's fragments (64 registers), O's accumulators
// (128) and S (32) at once, past the 255 registers a thread may have. So
// at E 256 the kernel (Bf16Form<256>) runs the same 64-row block with
// two warpgroups: each computes S = Q K^T whole (16 k steps of
// m64n64k16) and the same online max and sum, and owns one 128-column
// half of O (P V by m64n128k16 on its half of the V tile), so a thread
// holds 64 accumulators. S is computed twice, a third more products than
// one warpgroup would do, in exchange for no spills. Q is 32 KB and a K
// or V tile 32 KB: the two stages take 161 KB with the alignment pad, one
// block an SM.
#include "flash_tile.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int MAXR_S = 16;
constexpr int MAXR_PV = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int nq, int nkv, int E,
             int group, int blk_q, int causal, int window, int q_offset,
             int kv_len, float sm_scale) {
  const int iq = blockIdx.x, bh = blockIdx.y;
  const int row0 = iq * blk_q + q_offset;
  const int nkv_t = nkv / KV_TILE;
  const bool windowed = window > 0;
  const bool banded = causal || windowed;
  const bool tail = kv_len < nkv;
  const int t = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);          // (blk_q, KV_TILE)
  float* Qs = Ps + blk_q * KV_TILE;                    // (blk_q, E)
  float* M = Qs + blk_q * E;                           // running max
  float* Lsum = M + blk_q;                             // running sum
  float* A = Lsum + blk_q;                             // this tile's rescale
  T* Kt = reinterpret_cast<T*>(A + blk_q);             // (KV_TILE, E + pad)
  T* Vt = Kt + KV_TILE * (E + KV_ROW_PAD);

  // Thread layout: S tile column c, rows rg_s + 4 i; output columns
  // ce..ce+3, rows rg_pv + rstep_pv i.
  const int c = t % KV_TILE, rg_s = t / KV_TILE;
  const int nr_s = blk_q > rg_s ? (blk_q - rg_s + 3) / 4 : 0;
  const int cpr = E / 4;
  const int ce = (t % cpr) * 4, rg_pv = t / cpr, rstep_pv = THREADS / cpr;
  const int nr_pv = blk_q > rg_pv ? (blk_q - rg_pv + rstep_pv - 1) / rstep_pv : 0;

  stage_q(Qs, q + ((size_t)bh * nq + iq * blk_q) * E, blk_q, E);
  for (int r = t; r < blk_q; r += THREADS) {
    M[r] = NEG_INF;
    Lsum[r] = 0.f;
  }
  float acc[MAXR_PV][4];
#pragma unroll
  for (int i = 0; i < MAXR_PV; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const size_t kv_off = (size_t)(bh / group) * nkv * E;
  for (int j = 0; j < nkv_t; ++j) {
    const int col0 = j * KV_TILE;
    // Whole-tile skip: strictly above the causal diagonal, or entirely
    // older than the window of the block's newest row.
    bool run = true;
    if (banded) run = col0 <= row0 + blk_q - 1;
    if (windowed) run = run && (col0 + KV_TILE - 1 > row0 - window);
    if (!run) continue;

    __syncthreads();
    stage_rows(Kt, k + kv_off + (size_t)col0 * E, KV_TILE, KV_TILE, E);
    stage_rows(Vt, v + kv_off + (size_t)col0 * E, KV_TILE, KV_TILE, E);
    __syncthreads();

    bool need_mask = false;
    if (banded) need_mask = col0 + KV_TILE - 1 > row0;
    if (windowed) need_mask = need_mask || (col0 <= row0 + blk_q - 1 - window);
    if (tail) need_mask = need_mask || (col0 + KV_TILE > kv_len);

    float s_acc[MAXR_S];
    qk_dots<MAXR_S>(s_acc, Qs, Kt + c * (E + KV_ROW_PAD), E, nr_s, rg_s, 4);
    const int col = col0 + c;
#pragma unroll
    for (int i = 0; i < MAXR_S; ++i) {
      if (i < nr_s) {
        const int r = rg_s + 4 * i;
        float s = s_acc[i] * sm_scale;
        if (need_mask) {
          const int row = row0 + r;
          bool keep = true;
          if (banded) keep = col <= row;
          if (windowed) keep = keep && (col > row - window);
          if (tail) keep = keep && (col < kv_len);
          if (!keep) s = NEG_INF;
        }
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
        row[lane] = p0;
        row[lane + 32] = p1;
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

  T* ob = o + ((size_t)bh * nq + iq * blk_q) * E;
#pragma unroll
  for (int i = 0; i < MAXR_PV; ++i) {
    if (i < nr_pv) {
      const int r = rg_pv + i * rstep_pv;
      float l = Lsum[r];
      l = l == 0.f ? 1.f : l;  // rows that saw no key
      T* dst = ob + (size_t)r * E + ce;
      store(dst + 0, acc[i][0] / l);
      store(dst + 1, acc[i][1] / l);
      store(dst + 2, acc[i][2] / l);
      store(dst + 3, acc[i][3] / l);
    }
  }
}

constexpr int BQ = 64;             // bf16 form: query rows a block

// The bf16 form's warpgroups at head dim E: one of 4 warps of 16 rows, or
// at E 256 two, each with one 128-column half of O (EO columns).
template <int E>
struct Bf16Form {
  static constexpr int WGS = E == 256 ? 2 : 1;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int EO = E / WGS;
  static constexpr int MIN_BLOCKS = E == 256 ? 1 : 2;   // an SM
};

template <int E>
__global__ void __launch_bounds__(Bf16Form<E>::THREADS,
                                  Bf16Form<E>::MIN_BLOCKS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int nq, int nkv, int group,
                  int causal, int window, int q_offset, int kv_len,
                  float scale_log2) {
  constexpr int WGS = Bf16Form<E>::WGS, NT = Bf16Form<E>::THREADS;
  constexpr int EO = Bf16Form<E>::EO;
  constexpr int TILE = KV_TILE * E * 2;     // bytes of one K or V tile
  // the last Q blocks have the most live tiles: they go first
  const int iq = gridDim.x - 1 - blockIdx.x, bh = blockIdx.y;
  // this warpgroup's columns of O (0 for one warpgroup, at compile time)
  const int wg = WGS == 1 ? 0 : threadIdx.x / 128;
  const int row0 = iq * BQ + q_offset;
  const int nkv_t = nkv / KV_TILE;
  const bool windowed = window > 0;
  const bool banded = causal || windowed;
  const bool tail = kv_len < nkv;

  // Live tiles [j_lo, j_hi]: not strictly above the diagonal of the
  // block's last row, not wholly older than the window of its first row.
  int j_hi = nkv_t - 1, j_lo = 0;
  if (banded) j_hi = min(j_hi, (row0 + BQ - 1) / KV_TILE);
  if (windowed && row0 - window - (KV_TILE - 1) >= 0)
    j_lo = (row0 - window - (KV_TILE - 1)) / KV_TILE + 1;

  extern __shared__ __align__(16) unsigned char smem[];
  // sw128 tiles want 1024-byte alignment (the launch adds 1 KB for it)
  const uint32_t qs = (tc::smem_addr(smem) + 1023u) & ~1023u;  // (BQ, E)
  const uint32_t kv0 = qs + BQ * E * 2;          // stage s: K, then V
  const size_t kv_off = (size_t)(bh / group) * nkv * E;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

  tc::cp_rows_sw128<E, BQ>(qs, q + ((size_t)bh * nq + iq * BQ) * E, NT);
  if (j_lo <= j_hi) {
    tc::cp_rows_sw128<E, KV_TILE>(kv0, kb + (size_t)j_lo * KV_TILE * E, NT);
    tc::cp_rows_sw128<E, KV_TILE>(kv0 + TILE, vb + (size_t)j_lo * KV_TILE * E, NT);
  }
  tc::cp_async_commit();

  tc::OnlineRows<EO> st;
  st.init();

  for (int j = j_lo; j <= j_hi; ++j) {
    const uint32_t kt = kv0 + ((j - j_lo) & 1) * 2 * TILE, vt = kt + TILE;
    if (j < j_hi) {
      const uint32_t nk = kv0 + ((j + 1 - j_lo) & 1) * 2 * TILE;
      tc::cp_rows_sw128<E, KV_TILE>(nk, kb + (size_t)(j + 1) * KV_TILE * E, NT);
      tc::cp_rows_sw128<E, KV_TILE>(nk + TILE, vb + (size_t)(j + 1) * KV_TILE * E, NT);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    tc::fence_proxy_async();
    __syncthreads();
    // Q's fragments are loaded for every tile (see flash_tile.cuh)
    uint32_t qf[E / 16][4];
    tc::load_q_fragments<E, WGS>(qf, qs);

    const int col0 = j * KV_TILE;
    bool need_mask = false;
    if (banded) need_mask = col0 + KV_TILE - 1 > row0;
    if (windowed) need_mask = need_mask || (col0 <= row0 + BQ - 1 - window);
    if (tail) need_mask = need_mask || (col0 + KV_TILE > kv_len);
    auto keep = [&](int r, int c) {
      const int row = row0 + r, col = col0 + c;
      bool ok = true;
      if (banded) ok = col <= row;
      if (windowed) ok = ok && (col > row - window);
      if (tail) ok = ok && (col < kv_len);
      return ok;
    };
    // V's columns [EO wg, EO wg + EO): its sw128 halves from EO wg / 64
    tc::online_tile<E, false, EO>(st, qf, kt,
                                  vt + wg * (EO / 64) * (KV_TILE * 128),
                                  scale_log2, need_mask, keep, nullptr,
                                  nullptr);
    __syncthreads();   // the next copy overwrites this tile's stage
  }
  tc::cp_async_wait<0>();
  tc::store_rows<EO, WGS>(st, o + ((size_t)bh * nq + iq * BQ) * E + wg * EO,
                          E);
}

template <int E>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bhq,
                int nq, int nkv, int group, int causal, int window,
                int q_offset, int kv_len, float sm_scale,
                cudaStream_t stream) {
  // the Q block and two stages of one K and one V tile, plus 1 KB to align
  // them to 1024 bytes
  const size_t smem = 2ull * BQ * E + 2ull * 2 * KV_TILE * E * 2 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / BQ, bhq);
  flash_bf16_kernel<E><<<grid, Bf16Form<E>::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nq,
      nkv, group, causal, window, q_offset, kv_len,
      sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bhq, nq, E); k, v: (bhq / group, nkv, E); o: like q. Contiguous.
// nkv % KV_TILE == 0; window <= 0 means none.

// fp32, on the CUDA cores: nq % blk_q == 0.
extern "C" int flash_attention_fp32_launch(const void* q, const void* k,
                                           const void* v, void* o, int bhq,
                                           int nq, int nkv, int E, int group,
                                           int blk_q, int causal, int window,
                                           int q_offset, int kv_len,
                                           float sm_scale, void* stream) {
  const size_t smem = 4ull * blk_q * KV_TILE + 4ull * blk_q * E +
                      3ull * 4 * blk_q +
                      2ull * KV_TILE * (E + KV_ROW_PAD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / blk_q, bhq);
  flash_kernel<float><<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), nq, nkv, E, group,
      blk_q, causal, window, q_offset, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

// bf16, on the tensor cores (wgmma): E 64, 128 or 256, nq % 64 == 0, q, k
// and v 16-byte aligned.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int bhq,
                                           int nq, int nkv, int E, int group,
                                           int causal, int window,
                                           int q_offset, int kv_len,
                                           float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E == 128)
    return launch_bf16<128>(q, k, v, o, bhq, nq, nkv, group, causal, window,
                            q_offset, kv_len, sm_scale, s);
  if (E == 64)
    return launch_bf16<64>(q, k, v, o, bhq, nq, nkv, group, causal, window,
                           q_offset, kv_len, sm_scale, s);
  if (E == 256)
    return launch_bf16<256>(q, k, v, o, bhq, nq, nkv, group, causal, window,
                            q_offset, kv_len, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
