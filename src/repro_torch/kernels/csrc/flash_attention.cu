// Online-softmax attention for Hopper: kernel B3.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (flash_attention_flat; body _flash_kernel).
//
// What it computes: one thread block owns one (b*h, Q row block of blk_q
// rows) and walks the KV tiles in order with an online max/sum, so its
// working set is one (blk_q, KV_TILE) tile instead of a full score row;
// this is what serves rows too long for the MAS row buffer and every
// sliding-window call. Whole tiles above the causal diagonal or outside
// the window are skipped (no load, no compute); only boundary tiles are
// masked (causal, window, kv_len tail). Query row i sits at absolute
// position q_offset + i. Rows that saw no key (l == 0) write zeros.
//
// What bounds it on an H100: in this first version the two products run
// on the CUDA cores in fp32, so it is bound by instructions and latency
// rather than by device memory: the registers of 256 threads allow about
// one block per SM, and each tile is staged by one load after another per
// thread with nothing else in flight. K and V tiles are staged once per Q
// block and read from shared memory by all rows of the block,
// shared-memory reads are conflict-free (padded rows, broadcast Q/P
// reads), and the running output stays in registers. Tensor cores
// (mma/wgmma) and TMA pipelining are later work.
#include "common.cuh"

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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bhq,
           int nq, int nkv, int E, int group, int blk_q, int causal, int window,
           int q_offset, int kv_len, float sm_scale, cudaStream_t stream) {
  const size_t smem = 4ull * blk_q * KV_TILE + 4ull * blk_q * E +
                      3ull * 4 * blk_q +
                      2ull * KV_TILE * (E + KV_ROW_PAD) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / blk_q, bhq);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nq, nkv, E, group, blk_q,
      causal, window, q_offset, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bhq, nq, E); k, v: (bhq / group, nkv, E); o: like q. Contiguous.
// nq % blk_q == 0, nkv % KV_TILE == 0; window <= 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bhq, int nq,
                                      int nkv, int E, int group, int blk_q,
                                      int causal, int window, int q_offset,
                                      int kv_len, float sm_scale, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, bhq, nq, nkv, E, group, blk_q, causal,
                         window, q_offset, kv_len, sm_scale, s);
  return launch<__nv_bfloat16>(q, k, v, o, bhq, nq, nkv, E, group, blk_q,
                               causal, window, q_offset, kv_len, sm_scale, s);
}
