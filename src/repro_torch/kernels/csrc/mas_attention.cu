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
// B1 (mas_resident_launch) stages the live K and V rows of its (b*h) whole
// in shared memory next to the score row. B2 (mas_streamed_launch) is the
// paper's proactive-overwrite regime: K tiles stream through ONE shared
// buffer for the S pass, and the P V pass reads the V tiles AGAIN from
// device memory into that same buffer (the read inflation sim/ models).
//
// What bounds it on an H100: the score row caps N (policy.py sizes
// blk_q and routes longer rows to flash), and this first version runs its
// products on the CUDA cores in fp32 (FMA), far below the tensor-core
// rate, so it is bound by instructions and latency, not by device memory:
// the row buffer leaves room for one block per SM, and each thread stages
// its share of a tile with one 8- or 16-byte load after another, so the
// load latency is exposed. The design keeps shared-memory traffic
// conflict-free (padded K/V rows, broadcast Q/P reads) and holds the
// per-thread sums in registers. Tensor cores (mma/wgmma) and pipelined
// staging (cp.async/TMA) are later work.
#include "common.cuh"

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

size_t mas_smem_bytes(int blk_q, int nkv, int E, int itemsize, bool resident) {
  const size_t row = (size_t)(E + KV_ROW_PAD) * itemsize;
  size_t bytes = 4ull * blk_q * nkv + 4ull * blk_q * E;
  bytes += resident ? 2ull * nkv * row : (size_t)KV_TILE * row;
  return bytes;
}

template <typename T>
int launch(bool resident, const void* q, const void* k, const void* v, void* o,
           int bhq, int nq, int nkv, int E, int group, int blk_q, int causal,
           int kv_len, float sm_scale, cudaStream_t stream) {
  auto kernel = resident ? mas_resident_kernel<T> : mas_streamed_kernel<T>;
  const size_t smem = mas_smem_bytes(blk_q, nkv, E, sizeof(T), resident);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nq / blk_q, bhq);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nq, nkv, E, group, blk_q,
      causal, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

int dispatch(bool resident, const void* q, const void* k, const void* v,
             void* o, int bhq, int nq, int nkv, int E, int group, int blk_q,
             int causal, int kv_len, float sm_scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(resident, q, k, v, o, bhq, nq, nkv, E, group, blk_q,
                         causal, kv_len, sm_scale, s);
  return launch<__nv_bfloat16>(resident, q, k, v, o, bhq, nq, nkv, E, group,
                               blk_q, causal, kv_len, sm_scale, s);
}

}  // namespace

// q: (bhq, nq, E); k, v: (bhq / group, nkv, E); o: like q. Contiguous.
// nq % blk_q == 0, nkv % KV_TILE == 0. dtype 0 = fp32, 1 = bf16.
extern "C" int mas_resident_launch(const void* q, const void* k, const void* v,
                                   void* o, int bhq, int nq, int nkv, int E,
                                   int group, int blk_q, int causal, int kv_len,
                                   float sm_scale, int dtype, void* stream) {
  return dispatch(true, q, k, v, o, bhq, nq, nkv, E, group, blk_q, causal,
                  kv_len, sm_scale, dtype, stream);
}

extern "C" int mas_streamed_launch(const void* q, const void* k, const void* v,
                                   void* o, int bhq, int nq, int nkv, int E,
                                   int group, int blk_q, int causal, int kv_len,
                                   float sm_scale, int dtype, void* stream) {
  return dispatch(false, q, k, v, o, bhq, nq, nkv, E, group, blk_q, causal,
                  kv_len, sm_scale, dtype, stream);
}
