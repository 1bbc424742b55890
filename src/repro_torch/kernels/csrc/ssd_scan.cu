// The Mamba2 SSD intra-chunk step for Hopper: kernel B8.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py (ssd_intra_chunk;
// body _ssd_chunk_kernel).
//
// What it computes: for every (batch*head, chunk) cell of Q rows,
//   a_cum = cumsum(a)                                         (Q,)
//   L[i][j] = exp(a_cum[i] - a_cum[j]) for j <= i, else 0
//   y = (C B^T . L) X                                         (Q, P)
//   state = sum_t exp(a_cum[Q-1] - a_cum[t]) b_t x_t^T        (N, P)
// with x (Q, P), b and c (Q, N) in fp32 or bf16 and a (Q,) fp32; y and
// state are fp32.
//
// Why it is not the TPU's block: the TPU kernel holds a whole chunk's
// (Q, Q) score-and-decay tile, 256 KB at Q = 256, and the fp32 B and C
// of the chunk, another 256 KB; a Hopper block has at most 227 KB of
// shared memory. So the rows are split: a cell has ceil(Q / 64) row
// blocks and one state block. Row block r stages its 64 C rows once and
// walks the 64-column tiles j <= r only (the tiles above the diagonal are
// exactly zero in the TPU kernel, so skipping them is exact), staging a B
// tile and an X tile for each, forming the (64, 64) tile of C B^T . L in
// shared memory and accumulating its product with X in registers. The
// state block walks all Q rows in 64-row tiles, staging b_t scaled by its
// decay and x_t. Every block builds a_cum with a sequential fp32 prefix
// sum, one addition after another from the first row, the order of the
// plain version (ssd_scan.cumsum_sequential): at full width a*dt reaches
// about -11 a step and a_cum about -3000 within a chunk, so L near the
// diagonal is the difference of two large fp32 numbers and a parallel
// scan would round it differently.
//
// What bounds it on an H100: 4 x 2048 tokens of mamba2-130m (96 heads of
// 8 chunks) move about 202 MB (bf16 x, b, c, fp32 a, y and states once,
// 0.060 ms at 3.35 TB/s) and do 12.9 GFLOP over the visible pairs
// (0.013 ms on the tensor cores), so the card's bound is bytes. This
// first version runs both products on the CUDA cores in fp32 (16 FMAs
// per two 16-byte shared-memory reads, each thread a 4 x 4 register
// tile), which makes it bound by instructions, not by memory. Global
// loads are 16 bytes a thread, four of them issued before any is
// converted to fp32 and stored. Tensor cores (mma.sync / wgmma) and TMA
// staging are later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int ROWS = 64;           // rows of a row block; the column tile
constexpr int LDT = ROWS + 4;      // row stride of a transposed tile
constexpr int BATCH = 4;           // 16-byte loads a thread issues at once

// Sixteen bytes of T as fp32: four floats, or eight bf16 (a bf16 is the
// high half of the fp32 with the same bits, so the conversion is exact).
template <typename T> struct Unpack;
template <> struct Unpack<float> {
  static constexpr int N = 4;
  __device__ static void run(uint4 u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Unpack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void run(uint4 u, float (&f)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

struct NoScale {
  __device__ float operator()(int) const { return 1.f; }
};

// b_t's decay in the chunk state: exp(a_cum[Q-1] - a_cum[t0 + r]).
struct StateDecay {
  const float* acum;
  float last;
  int t0;
  __device__ float operator()(int r) const {
    return expf(last - acum[t0 + r]);
  }
};

// Stage ROWS rows of W elements (src: the first row, row stride W) into
// shared memory as fp32, each row times scale(r): transposed
// (dst[w * LDT + r]) or by rows (dst[r * ld + w], ld = W + 4). Rows at or
// past `valid` are zero-filled. Each thread issues BATCH 16-byte loads
// before it converts and stores any.
template <typename T, bool TRANSPOSE, typename Scale>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int valid, int W, Scale scale) {
  constexpr int VEC = Unpack<T>::N;
  const int cpr = W / VEC;
  const int n = ROWS * cpr;
  const int ld = TRANSPOSE ? LDT : W + 4;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * THREADS) {
    uint4 u[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * THREADS;
      // transposed: neighbouring threads take neighbouring rows, so their
      // shared-memory stores fall on distinct banks
      const int r = TRANSPOSE ? i % ROWS : i / cpr;
      const int ch = TRANSPOSE ? i / ROWS : i % cpr;
      u[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && r < valid) {
        u[k] = *reinterpret_cast<const uint4*>(src + (size_t)r * W +
                                               ch * VEC);
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * THREADS;
      if (i >= n) break;
      const int r = TRANSPOSE ? i % ROWS : i / cpr;
      const int ch = TRANSPOSE ? i / ROWS : i % cpr;
      float f[VEC];
      Unpack<T>::run(u[k], f);
      const float s = r < valid ? scale(r) : 0.f;
      if (TRANSPOSE) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[(ch * VEC + e) * LDT + r] = f[e] * s;
      } else {
        float* d = dst + r * ld + ch * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          *reinterpret_cast<float4*>(d + e) =
              make_float4(f[e] * s, f[e + 1] * s, f[e + 2] * s, f[e + 3] * s);
        }
      }
    }
  }
}

// Shared-memory floats of the prefix sums (rounded up to keep the tiles
// after them 16-byte aligned).
__host__ __device__ constexpr int acum_floats(int Q) { return (Q + 3) / 4 * 4; }

// One block per (cell, row block) and one per (cell, state): blockIdx.x =
// cell * (n_rb + 1) + rb, rb == n_rb the state block.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ b, const T* __restrict__ c,
                 float* __restrict__ y, float* __restrict__ states, int Q,
                 int N, int P) {
  const int n_rb = (Q + ROWS - 1) / ROWS;
  const int cell = blockIdx.x / (n_rb + 1);
  const int rb = blockIdx.x - cell * (n_rb + 1);
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Acum = reinterpret_cast<float*>(smem);
  float* tiles = Acum + acum_floats(Q);

  const T* xc = x + (size_t)cell * Q * P;
  const T* bc = b + (size_t)cell * Q * N;
  const T* cc = c + (size_t)cell * Q * N;

  // a_cum: loaded by all threads, summed in order by one
  for (int i = t; i < Q; i += THREADS) Acum[i] = a[(size_t)cell * Q + i];
  __syncthreads();
  if (t == 0) {
    float run = 0.f;
    for (int i = 0; i < Q; ++i) {
      run += Acum[i];
      Acum[i] = run;
    }
  }

  if (rb == n_rb) {
    // chunk state (N, P): thread rows 8 ty .. 8 ty + 7, columns 4 tx ..
    float* Bd = tiles;                       // (ROWS, N + 4), b_t * decay
    float* Xs = Bd + ROWS * (N + 4);         // (ROWS, P + 4)
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    __syncthreads();                         // a_cum complete
    const float last = Acum[Q - 1];
    const bool live = 8 * ty < N && 4 * tx < P;
    for (int t0 = 0; t0 < Q; t0 += ROWS) {
      const int valid = min(ROWS, Q - t0);
      __syncthreads();                       // the last tile is read
      stage_tile<T, false>(Bd, bc + (size_t)t0 * N, valid, N,
                           StateDecay{Acum, last, t0});
      stage_tile<T, false>(Xs, xc + (size_t)t0 * P, valid, P, NoScale{});
      __syncthreads();
      if (live) {
        for (int r = 0; r < valid; ++r) {
          const float4 b0 = *reinterpret_cast<const float4*>(Bd + r * (N + 4) + 8 * ty);
          const float4 b1 = *reinterpret_cast<const float4*>(Bd + r * (N + 4) + 8 * ty + 4);
          const float4 xv = *reinterpret_cast<const float4*>(Xs + r * (P + 4) + 4 * tx);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] = fmaf(bv[i], xv.x, acc[i][0]);
            acc[i][1] = fmaf(bv[i], xv.y, acc[i][1]);
            acc[i][2] = fmaf(bv[i], xv.z, acc[i][2]);
            acc[i][3] = fmaf(bv[i], xv.w, acc[i][3]);
          }
        }
      }
    }
    if (live) {
      float* out = states + (size_t)cell * N * P;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<float4*>(out + (8 * ty + i) * P + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    return;
  }

  // row block rb: y rows r0 + 4 ty + i (i < 4), columns 4 tx .. 4 tx + 3
  float* Cs = tiles;                         // (N, LDT): C rows, transposed
  float* Bs = Cs + N * LDT;                  // (N, LDT): B rows, transposed
  float* Xs = Bs + N * LDT;                  // (ROWS, P + 4)
  float* Ss = Xs + ROWS * (P + 4);           // (ROWS, LDT): (C B^T . L)^T
  const int r0 = rb * ROWS;
  stage_tile<T, true>(Cs, cc + (size_t)r0 * N, min(ROWS, Q - r0), N,
                      NoScale{});
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int jt = 0; jt <= rb; ++jt) {
    const int c0 = jt * ROWS;
    const int valid = min(ROWS, Q - c0);
    __syncthreads();                         // a_cum complete; last tile read
    stage_tile<T, true>(Bs, bc + (size_t)c0 * N, valid, N, NoScale{});
    stage_tile<T, false>(Xs, xc + (size_t)c0 * P, valid, P, NoScale{});
    __syncthreads();
    // scores (C B^T)[4 ty + i][4 tx + j] over N, then the decay and mask
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    for (int k = 0; k < N; ++k) {
      const float4 cv = *reinterpret_cast<const float4*>(Cs + k * LDT + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + k * LDT + 4 * tx);
      const float ci[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(ci[i], bv.x, s[i][0]);
        s[i][1] = fmaf(ci[i], bv.y, s[i][1]);
        s[i][2] = fmaf(ci[i], bv.z, s[i][2]);
        s[i][3] = fmaf(ci[i], bv.w, s[i][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = c0 + 4 * tx + j;
      float col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = r0 + 4 * ty + i;
        col[i] = (gj <= gi && gi < Q)
                     ? s[i][j] * expf(Acum[gi] - Acum[gj]) : 0.f;
      }
      *reinterpret_cast<float4*>(Ss + (4 * tx + j) * LDT + 4 * ty) =
          make_float4(col[0], col[1], col[2], col[3]);
    }
    __syncthreads();
    if (4 * tx < P) {
      for (int j = 0; j < valid; ++j) {
        const float4 sv = *reinterpret_cast<const float4*>(Ss + j * LDT + 4 * ty);
        const float4 xv = *reinterpret_cast<const float4*>(Xs + j * (P + 4) + 4 * tx);
        const float si[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(si[i], xv.x, acc[i][0]);
          acc[i][1] = fmaf(si[i], xv.y, acc[i][1]);
          acc[i][2] = fmaf(si[i], xv.z, acc[i][2]);
          acc[i][3] = fmaf(si[i], xv.w, acc[i][3]);
        }
      }
    }
  }
  if (4 * tx < P) {
    float* out = y + (size_t)cell * Q * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = r0 + 4 * ty + i;
      if (gi < Q) {
        *reinterpret_cast<float4*>(out + (size_t)gi * P + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

// Shared-memory bytes of a block: the row block's tiles, the larger.
size_t smem_bytes(int Q, int N, int P) {
  const size_t rows = 2 * (size_t)N * LDT + (size_t)ROWS * (P + 4) +
                      (size_t)ROWS * LDT;
  const size_t state = (size_t)ROWS * (N + 4) + (size_t)ROWS * (P + 4);
  return (acum_floats(Q) + (rows > state ? rows : state)) * sizeof(float);
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, void* states, int cells, int Q, int N, int P,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N, P);
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_rb = (Q + ROWS - 1) / ROWS;
  ssd_chunk_kernel<T><<<cells * (n_rb + 1), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<float*>(y), static_cast<float*>(states), Q, N, P);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (cells, Q, P) and b, c: (cells, Q, N) of one type (dtype 0 fp32, 1
// bf16); a: (cells, Q) fp32; y: (cells, Q, P) fp32; states: (cells, N, P)
// fp32. Contiguous, 16-byte aligned; N and P multiples of 8, N <= 128,
// P <= 64.
extern "C" int ssd_intra_chunk_launch(const void* x, const void* a,
                                      const void* b, const void* c, void* y,
                                      void* states, int cells, int Q, int N,
                                      int P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, a, b, c, y, states, cells, Q, N, P, s);
  }
  return launch<float>(x, a, b, c, y, states, cells, Q, N, P, s);
}
