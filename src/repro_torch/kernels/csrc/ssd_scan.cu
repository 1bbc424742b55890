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
// state are fp32. Every form builds a_cum with a sequential fp32 prefix
// sum, one addition after another from the first row, the order of the
// plain version (ssd_scan.cumsum_sequential): at full width a*dt reaches
// about -11 a step and a_cum about -3000 within a chunk, so L near the
// diagonal is the difference of two large fp32 numbers and a parallel
// scan would round it differently.
//
// What bounds it on an H100: 4 x 2048 tokens of mamba2-130m (96 heads of
// 8 chunks) move about 202 MB (bf16 x, b, c, fp32 a, y and states once,
// 0.060 ms at 3.35 TB/s) and do 12.9 GFLOP over the visible pairs
// (0.013 ms on the tensor cores), so the card's bound is bytes.
//
// Two forms, chosen by the inputs' type (ssd_scan.entry_point):
//
// * bf16 (ssd_intra_chunk_bf16_launch, Q <= 256): on the tensor cores, one
//   persistent block an SM walking its share of the cells. The TPU
//   kernel's block held the chunk's whole (Q, Q) score tile; here a block
//   holds a cell's bf16 C, B and X in shared memory (160 KB at Q = 256,
//   N = 128, P = 64) as four 64-row tile sets, each read from device
//   memory once, kept bf16, and brought in by tensor-map (TMA) copies in
//   the 128-byte swizzle the products read. A fifth slot holds the next
//   cell's first set, and each slot, once the three warpgroups are done
//   with its set, takes the next set in line, so the next cell's copies
//   run under this cell's products (a form that loaded a cell only after
//   the one before took 0.149 ms at 768 cells, 0.103 ms of it with no
//   loads at all; scripts/b8_variants.py, H100 80GB HBM3).
//   Warpgroup 0 computes y's 64-row stripes 0 and 3, warpgroup 1 stripes
//   1 and 2 (five 64 x 64 tiles on or below the diagonal each; tiles
//   above it are exactly zero in the TPU kernel and are skipped), and
//   warpgroup 2 the state, a_cum (one thread, sequentially) and the
//   decays a cell ahead, and S's diagonal c_i . b_i as chains of fp32
//   FMAs in k order, a row a thread, which replaces the tensor cores'
//   sum of it: at the model's decay a row of y is mostly S_ii x_i, and a
//   sum in another order misses the 1e-4 row limit on rows whose S_ii is
//   near 0. (On the y warps, under their products, the chains cost
//   registers and time: 0.123 ms and 44 bytes of spills against 0.113.)
//   Every product is a wgmma m64n64k16 with fp32 accumulators. L is
//   applied in registers, factored through a row between j and i so that
//   exp runs once a row and a column rather than once an element, and
//   S . L enters its product with X as bf16 hi + lo, as the decay-scaled
//   B^T enters the state's: one bf16 rounding of either moves a row by
//   ~2e-3-4e-3, forty times the limit (tests/test_torch_tc_rounding.py).
// * fp32 (ssd_intra_chunk_fp32_launch, Q <= 2048): the CUDA-core form.
//   A whole chunk's fp32 B and C do not fit a block, so the rows are
//   split: a cell has ceil(Q / 64) row blocks and one state block. Row
//   block r stages its 64 C rows once and walks the 64-column tiles
//   j <= r only, staging a B tile and an X tile for each, forming the
//   (64, 64) tile of C B^T . L in shared memory and accumulating its
//   product with X in registers. The state block walks all Q rows in
//   64-row tiles, staging b_t scaled by its decay and x_t. Both products
//   run on the CUDA cores in fp32 (16 FMAs per two 16-byte shared-memory
//   reads, each thread a 4 x 4 register tile), bound by instructions.
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int ROWS = 64;           // rows of a row block; the column tile
constexpr int LDT = ROWS + 4;      // row stride of a transposed tile
constexpr int BATCH = 4;           // 16-byte loads a thread issues at once

// Sixteen bytes of T as fp32 (the fp32 form's only T).
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

// --- the bf16 form on the tensor cores --------------------------------------

namespace tcf {

using tc::bf16;

constexpr int TILE = 64;                 // rows of a tile set, of a y stripe
constexpr int MAX_Q = 256;               // four tile sets
constexpr int MAX_SETS = MAX_Q / TILE;
constexpr int SLOTS = MAX_SETS + 1;      // a cell's sets and one more
constexpr int HALF = TILE * 128;         // a 64-column half of a sw128 tile
constexpr int SET = 5 * HALF;            // C (two halves), B (two), X (one)
constexpr int WG = 128;                  // threads of a warpgroup
constexpr int THREADS = 3 * WG;          // y stripes {0, 3}; {1, 2}; state
constexpr int RELEASERS = 3;             // warpgroups that free a set's slot

// Byte offsets in shared memory (from a 1024-byte aligned base) for
// chunks of Q rows, rounded up to whole tile sets: the slots of the tile
// sets (each set's C, B and X tiles in the 128-byte swizzle of mma.cuh,
// sw128<64>, as the tensor-map copies lay them down); a_cum, the state's
// decays and S's diagonal for two cells (one being worked on, the next
// being prepared); each y warpgroup's column factors of L; the slots'
// release counters; the mbarriers: a slot's copies landed (SLOTS), a
// cell's a_cum and decays ready (2), a tile set of its S diagonal ready
// (2 x MAX_SETS), the y warpgroups done with a cell (2).
struct Layout {
  int rows, sets, acum, decay, diag, colf, rel, bars, bytes;
  __host__ __device__ explicit Layout(int q) {
    rows = (q + TILE - 1) / TILE * TILE;
    sets = rows / TILE;
    acum = (sets + 1) * SET;
    decay = acum + 2 * rows * 4;
    diag = decay + 2 * rows * 4;
    colf = diag + 2 * rows * 4;
    rel = colf + 2 * rows * 4;
    bars = rel + SLOTS * 4 + 4;   // 8-byte aligned (rows * 4 is)
    bytes = bars + (SLOTS + 2 + 2 * MAX_SETS + 2) * 8 + 1024;
  }
};

// Wait for the phase of bar with this parity; trap after ~2^31 polls (a
// phase that never completes is a fault, not a hang).
__device__ __forceinline__ void wait_phase(uint32_t bar, int parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0x80000000u) __trap();
  }
}

// A 64 x 64 box of a bf16 tensor map at (column c0, row r0) into the
// shared memory at dst (1024-byte aligned), completing bytes on bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// The two bf16 of v (k and k + 1 of an A fragment) times their decays, as
// hi + lo pairs.
__device__ __forceinline__ void scale_split(uint32_t v, float d0, float d1,
                                            uint32_t& hi, uint32_t& lo) {
  tc::split(__uint_as_float(v << 16) * d0,
            __uint_as_float(v & 0xffff0000u) * d1, hi, lo);
}

// One persistent block an SM, walking the cells blockIdx.x, blockIdx.x +
// gridDim.x, ... A cell's tile sets are numbered in the block's order, s =
// (the block's cell index) * sets + k, and set s lands in slot s % (sets +
// 1) by three tensor-map copies (C's and B's two 64-column halves, X); the
// last of the three warpgroups to free a slot starts the copies of set s +
// sets + 1 into it, so the next cell's sets land while this one is worked.
// Warpgroup 0 computes y's 64-row stripes 0 and 3, warpgroup 1 stripes 1
// and 2 (five 64 x 64 tiles of (C B^T . L) X on or below the diagonal
// each); warpgroup 2 builds each cell's a_cum and decays a cell ahead, S's
// diagonal, and the state. Every product is a wgmma m64n64k16 with fp32
// accumulators: S = C B^T with C's A fragments in registers and the B tile
// (K-major) through its descriptor; y += (S . L) X and state += (B^T .
// decay) X with the A fragments in registers as bf16 hi + lo and the X
// tile (MN-major) through its descriptor.
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_bf16_kernel(const __grid_constant__ CUtensorMap tm_c,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __grid_constant__ CUtensorMap tm_x,
                      const float* __restrict__ a, float* __restrict__ y,
                      float* __restrict__ states, int cells, int Q, int N,
                      int P) {
  const Layout L(Q);
  const int S = L.sets, NS = S + 1;
  const int n_cells = (cells - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int wg = t / WG, tw = t % WG, w = warp % 4;
  const int g = lane >> 2, q4 = lane & 3;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t base = (tc::smem_addr(tc_smem) + 1023u) & ~1023u;
  unsigned char* const smem = tc_smem + (base - tc::smem_addr(tc_smem));
  auto slot = [&](int s) { return base + (s % NS) * SET; };
  auto full = [&](int s) { return base + L.bars + 8 * (s % NS); };
  auto parity = [&](int s) { return (s / NS) & 1; };
  const uint32_t acum_ready = base + L.bars + 8 * SLOTS;           // [2]
  const uint32_t diag_ready = acum_ready + 16;                     // [2][MAX_SETS]
  const uint32_t y_done = diag_ready + 16 * MAX_SETS;              // [2]
  int* const rel = reinterpret_cast<int*>(smem + L.rel);
  const int nbox = N > 64 ? 2 : 1;
  const uint32_t set_bytes = (2 * nbox + 1) * HALF;

  // the copies of set s (if the block has it) into its slot
  auto issue = [&](int s) {
    if (s >= n_cells * S) return;
    const int cell = (int)blockIdx.x + (s / S) * (int)gridDim.x;
    const int row = cell * Q + (s % S) * TILE;
    const uint32_t dst = slot(s), bar = full(s);
    expect_tx(bar, set_bytes);
    for (int h = 0; h < nbox; ++h) {
      tma_box(dst + h * HALF, &tm_c, h * 64, row, bar);
      tma_box(dst + (2 + h) * HALF, &tm_b, h * 64, row, bar);
    }
    tma_box(dst + 4 * HALF, &tm_x, 0, row, bar);
  };
  // a warpgroup frees set s's slot (after its threads' last reads); the
  // third to free it starts the copies of the set that takes it next (a
  // slot's counter grows by RELEASERS a use)
  auto release = [&](int s, int bar_id) {
    tc::bar_sync(bar_id, WG);
    if (tw == 0 && atomicAdd(rel + s % NS, 1) % RELEASERS == RELEASERS - 1) {
      issue(s + NS);
    }
  };

  if (t == 0) {
    for (int i = 0; i < NS; ++i) {
      tc::mbar_init(full(i), 1);
      rel[i] = 0;
    }
    for (int i = 0; i < 2; ++i) {
      tc::mbar_init(acum_ready + 8 * i, WG);
      tc::mbar_init(y_done + 8 * i, 2 * WG);
      for (int k = 0; k < MAX_SETS; ++k) tc::mbar_init(diag_ready + 8 * (i * MAX_SETS + k), TILE);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int s = 0; s < NS; ++s) issue(s);
  }

  const int nk = (N + 15) / 16;
  if (wg < 2) {
    // y: the warpgroup's stripes, the warp 16 rows of each.
    //
    // L[i][j] = exp(a_cum[i] - a_cum[j]) factors through a row m with
    // j <= m <= i, each factor at most 1: exp(a_cum[i] - a_cum[m]) *
    // exp(a_cum[m] - a_cum[j]), within two roundings of the plain
    // version's exp. Below the stripe's diagonal tile m is the stripe's
    // first row R0, whose column factors the warpgroup computes once
    // (colf); in the diagonal tile's 16-column blocks left of the warp's
    // own, m is the warp's first row; on the warp's own 16 x 16 diagonal
    // block each element takes its own exp.
    const int bar = 1 + wg, np = P / 8;
    // the last stripe this warpgroup works on: it frees each set there
    const int first = wg == 0 ? 0 : 1, second = wg == 0 ? 3 : 2;
    const int r_last = second < S ? second : first < S ? first : -1;
    float* const colf = reinterpret_cast<float*>(smem + L.colf) + wg * L.rows;
    for (int ci = 0; ci < n_cells; ++ci) {
      const int cell = (int)blockIdx.x + ci * (int)gridDim.x, s0 = ci * S;
      const int cb = ci & 1, ph = (ci >> 1) & 1;
      const float* const acum = reinterpret_cast<float*>(smem + L.acum) + cb * L.rows;
      const float* const diag = reinterpret_cast<float*>(smem + L.diag) + cb * L.rows;
      for (int si = 0; si < 2; ++si) {
        const int r = si == 0 ? first : second;
        if (r >= S) continue;                     // warpgroup-uniform
        const int R0 = r * TILE, row0 = R0 + w * 16;
        const int i0 = row0 + g, i1 = i0 + 8;
        tc::bar_sync(bar, WG);                    // the last stripe's colf read
        wait_phase(acum_ready + 8 * cb, ph);
        for (int j = tw; j < R0; j += WG) colf[j] = expf(acum[R0] - acum[j]);
        tc::bar_sync(bar, WG);
        const float rf0 = expf(acum[i0] - acum[R0]), rf1 = expf(acum[i1] - acum[R0]);
        const float rg0 = expf(acum[i0] - acum[row0]), rg1 = expf(acum[i1] - acum[row0]);
        float yacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
        wait_phase(full(s0 + r), parity(s0 + r));
        for (int jt = 0; jt <= r; ++jt) {
          wait_phase(full(s0 + jt), parity(s0 + jt));
          const bool on_diag = jt == r;
          const uint32_t cs = slot(s0 + r), bs = slot(s0 + jt) + 2 * HALF,
                         xs = slot(s0 + jt) + 4 * HALF;
          // S = C B^T over this tile's 64 columns: C's fragments are
          // loaded for every tile, none is carried across the loop in
          // registers
          uint32_t ca[8][4];
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk < nk) {
              tc::ldsm_x4(ca[kk], cs + tc::sw128<TILE>(w * 16 + (lane & 15),
                                                       kk * 16 + (lane >> 4) * 8));
            }
          }
          float s[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = 0.f;
          tc::fence_regs(s);
          tc::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk < nk) {
              tc::wgmma_m64n64k16<0>(
                  s, ca[kk], tc::gmma_desc(bs + (kk / 4) * HALF + (kk % 4) * 32, 16, 1024));
            }
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(s);
          tc::fence_regs(ca);
          if (on_diag) {
            // S_ii from warpgroup 2, in the places of the diagonal
            wait_phase(diag_ready + 8 * (cb * MAX_SETS + r), ph);
            const float d0 = diag[i0], d1 = diag[i1];
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              if ((nb >> 1) != w) continue;
              const int col = (nb & 1) * 8 + 2 * q4;   // from column 16 w
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (col + e == g) s[4 * nb + e] = d0;
                if (col + e == g + 8) s[4 * nb + 2 + e] = d1;
              }
            }
          }
          // S . L as the A fragments of y's k16 steps, bf16 hi + lo
          uint32_t hi[4][4], lo[4][4];
#pragma unroll
          for (int kj = 0; kj < 4; ++kj) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int nb = 2 * kj + h;
              const int j = jt * TILE + nb * 8 + 2 * q4;
              float l00, l01, l10, l11;
              if (!on_diag) {
                const float c0 = colf[j], c1 = colf[j + 1];
                l00 = rf0 * c0; l01 = rf0 * c1; l10 = rf1 * c0; l11 = rf1 * c1;
              } else if (kj < w) {
                const float c0 = expf(acum[row0] - acum[j]);
                const float c1 = expf(acum[row0] - acum[j + 1]);
                l00 = rg0 * c0; l01 = rg0 * c1; l10 = rg1 * c0; l11 = rg1 * c1;
              } else if (kj == w) {
                const float ai0 = acum[i0], ai1 = acum[i1];
                const float aj0 = acum[j], aj1 = acum[j + 1];
                l00 = j <= i0 ? expf(ai0 - aj0) : 0.f;
                l01 = j + 1 <= i0 ? expf(ai0 - aj1) : 0.f;
                l10 = j <= i1 ? expf(ai1 - aj0) : 0.f;
                l11 = j + 1 <= i1 ? expf(ai1 - aj1) : 0.f;
              } else {                                  // above the diagonal
                l00 = l01 = l10 = l11 = 0.f;
              }
              tc::split(s[4 * nb] * l00, s[4 * nb + 1] * l01, hi[kj][2 * h],
                        lo[kj][2 * h]);
              tc::split(s[4 * nb + 2] * l10, s[4 * nb + 3] * l11,
                        hi[kj][2 * h + 1], lo[kj][2 * h + 1]);
            }
          }
          tc::fence_regs(yacc);
          tc::fence_regs(hi);
          tc::fence_regs(lo);
          tc::wgmma_fence();
#pragma unroll
          for (int kj = 0; kj < 4; ++kj) {
            const uint64_t dx = tc::gmma_desc(xs + kj * 16 * 128, HALF, 1024);
            tc::wgmma_m64n64k16<1>(yacc, hi[kj], dx);
            tc::wgmma_m64n64k16<1>(yacc, lo[kj], dx);
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(yacc);
          tc::fence_regs(hi);
          tc::fence_regs(lo);
          if (r == r_last && jt < r) release(s0 + jt, bar);
        }
        float* const yo = y + (size_t)cell * Q * P;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          if (nb >= np) break;
          const int col = nb * 8 + 2 * q4;
          if (i0 < Q) {
            *reinterpret_cast<float2*>(yo + (size_t)i0 * P + col) =
                make_float2(yacc[4 * nb], yacc[4 * nb + 1]);
          }
          if (i1 < Q) {
            *reinterpret_cast<float2*>(yo + (size_t)i1 * P + col) =
                make_float2(yacc[4 * nb + 2], yacc[4 * nb + 3]);
          }
        }
        if (r == r_last) release(s0 + r, bar);
      }
      // the sets this warpgroup does not use, freed once they are in their
      // slots (a set freed before its copies were started would count as
      // a release of the set the slot still holds)
      for (int k = r_last + 1; k < S; ++k) {
        wait_phase(full(s0 + k), parity(s0 + k));
        release(s0 + k, bar);
      }
      tc::mbar_arrive(y_done + 8 * cb);           // done with the cell's buffers
    }
    return;
  }

  // Warpgroup 2: a_cum in cumsum_sequential's order (rows past Q add a =
  // 0), one thread, and the state's decays exp(a_cum[Q-1] - a_cum[t]), 0
  // past Q, of cell index ci into buffer ci & 1, once the y warpgroups are
  // done with the cell that used it before. The cell's a (this thread's
  // rows tw, tw + 128) is read a cell ahead, into av.
  float av[MAX_Q / WG];
  auto load_a = [&](int ci) {
    const int cell = (int)blockIdx.x + ci * (int)gridDim.x;
#pragma unroll
    for (int h = 0; h < MAX_Q / WG; ++h) {
      const int i = tw + h * WG;
      av[h] = i < Q ? __ldg(a + (size_t)cell * Q + i) : 0.f;
    }
  };
  auto prepare = [&](int ci) {
    const int cb = ci & 1;
    if (ci >= 2) wait_phase(y_done + 8 * cb, ((ci - 2) >> 1) & 1);
    float* const acum = reinterpret_cast<float*>(smem + L.acum) + cb * L.rows;
    float* const decay = reinterpret_cast<float*>(smem + L.decay) + cb * L.rows;
#pragma unroll
    for (int h = 0; h < MAX_Q / WG; ++h) {
      if (tw + h * WG < L.rows) acum[tw + h * WG] = av[h];
    }
    tc::bar_sync(3, WG);
    if (tw == 0) {
      // eight at a time, the next eight read while these are summed
      float run = 0.f, v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = acum[e];
      for (int i0 = 0; i0 < L.rows; i0 += 8) {
        float nv[8];
        const int nx = i0 + 8 < L.rows ? i0 + 8 : i0;
#pragma unroll
        for (int e = 0; e < 8; ++e) nv[e] = acum[nx + e];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          run += v[e];
          acum[i0 + e] = run;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = nv[e];
      }
    }
    tc::bar_sync(3, WG);
    const float last = acum[Q - 1];
    for (int i = tw; i < L.rows; i += WG) {
      decay[i] = i < Q ? expf(last - acum[i]) : 0.f;
    }
    tc::mbar_arrive(acum_ready + 8 * cb);
  };

  // The state (N, P) in m64 blocks of N: B^T's A fragments by
  // ldmatrix.trans, times the decays, as hi + lo, into wgmma with the X
  // tile, over the tile sets as they land. Before a set's products,
  // warps 8 and 9 sum its rows' c_i . b_i (S's diagonal) as fp32 FMA
  // chains in k order, a row a thread: the order of the card's fp32
  // matrix product, which the plain version runs.
  const int nmb = (N + 63) / 64;
  if (n_cells > 0) {
    load_a(0);
    prepare(0);
  }
  for (int ci = 0; ci < n_cells; ++ci) {
    const int cell = (int)blockIdx.x + ci * (int)gridDim.x, s0 = ci * S;
    const int cb = ci & 1;
    const float* const decay = reinterpret_cast<float*>(smem + L.decay) + cb * L.rows;
    float* const diag = reinterpret_cast<float*>(smem + L.diag) + cb * L.rows;
    tc::bar_sync(3, WG);   // the decays, for the whole warpgroup
    if (ci + 1 < n_cells) load_a(ci + 1);
    float st[2][32];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) st[mb][i] = 0.f;
    for (int k = 0; k < S; ++k) {
      wait_phase(full(s0 + k), parity(s0 + k));
      const uint32_t cs = slot(s0 + k), bs = cs + 2 * HALF, xs = cs + 4 * HALF;
      if (tw < TILE) {
        float s0d = 0.f;
#pragma unroll 4
        for (int ch = 0; ch < N / 8; ++ch) {
          const uint4 cv = *reinterpret_cast<const uint4*>(
              smem + (cs - base) + tc::sw128<TILE>(tw, ch * 8));
          const uint4 bv = *reinterpret_cast<const uint4*>(
              smem + (bs - base) + tc::sw128<TILE>(tw, ch * 8));
          const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
          const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s0d = fmaf(__uint_as_float(cw[e] << 16),
                       __uint_as_float(bw[e] << 16), s0d);
            s0d = fmaf(__uint_as_float(cw[e] & 0xffff0000u),
                       __uint_as_float(bw[e] & 0xffff0000u), s0d);
          }
        }
        diag[k * TILE + tw] = s0d;
        tc::mbar_arrive(diag_ready + 8 * (cb * MAX_SETS + k));
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const int t0 = k * TILE + kt * 16;
        const float d0 = decay[t0 + 2 * q4], d1 = decay[t0 + 2 * q4 + 1];
        const float d2 = decay[t0 + 8 + 2 * q4], d3 = decay[t0 + 9 + 2 * q4];
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          uint32_t bf[4] = {0u, 0u, 0u, 0u};
          if (mb < nmb) {
            tc::ldsm_x4_t(bf, bs + tc::sw128<TILE>(kt * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                   mb * 64 + w * 16 + ((lane >> 3) & 1) * 8));
          }
          scale_split(bf[0], d0, d1, ah[mb][0], al[mb][0]);
          scale_split(bf[1], d0, d1, ah[mb][1], al[mb][1]);
          scale_split(bf[2], d2, d3, ah[mb][2], al[mb][2]);
          scale_split(bf[3], d2, d3, ah[mb][3], al[mb][3]);
        }
        tc::fence_regs(st[0]);
        tc::fence_regs(st[1]);
        tc::fence_regs(ah);
        tc::fence_regs(al);
        tc::wgmma_fence();
        const uint64_t dx = tc::gmma_desc(xs + kt * 16 * 128, HALF, 1024);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          if (mb < nmb) {
            tc::wgmma_m64n64k16<1>(st[mb], ah[mb], dx);
            tc::wgmma_m64n64k16<1>(st[mb], al[mb], dx);
          }
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(st[0]);
        tc::fence_regs(st[1]);
        tc::fence_regs(ah);
        tc::fence_regs(al);
      }
      release(s0 + k, 3);
    }
    float* const so = states + (size_t)cell * N * P;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      if (mb >= nmb) break;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = nb * 8 + 2 * q4;
        if (col >= P) break;
        const int n0 = mb * 64 + w * 16 + g, n1 = n0 + 8;
        if (n0 < N) {
          *reinterpret_cast<float2*>(so + (size_t)n0 * P + col) =
              make_float2(st[mb][4 * nb], st[mb][4 * nb + 1]);
        }
        if (n1 < N) {
          *reinterpret_cast<float2*>(so + (size_t)n1 * P + col) =
              make_float2(st[mb][4 * nb + 2], st[mb][4 * nb + 3]);
        }
      }
    }
    if (ci + 1 < n_cells) prepare(ci + 1);
  }
}

}  // namespace tcf

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (rows, cols) row-major bf16 matrix as 64 x 64 boxes in the 128-byte
// swizzle; columns past cols and rows past rows read as zeros.
bool bf16_map(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64}, step[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: (cells, Q, P) and b, c: (cells, Q, N); a: (cells, Q) fp32; y:
// (cells, Q, P) fp32; states: (cells, N, P) fp32. Contiguous, 16-byte
// aligned; N and P multiples of 8, N <= 128, P <= 64.

// bf16 x, b, c; Q <= 256: the tensor-core form, one persistent block an
// SM.
extern "C" int ssd_intra_chunk_bf16_launch(const void* x, const void* a,
                                           const void* b, const void* c,
                                           void* y, void* states, int cells,
                                           int Q, int N, int P, void* stream) {
  if (Q < 1 || Q > tcf::MAX_Q) return (int)cudaErrorInvalidValue;
  if (cells < 1) return (int)cudaSuccess;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_c, tm_b, tm_x;
  if (!bf16_map(&tm_c, c, cells * Q, N) ||
      !bf16_map(&tm_b, b, cells * Q, N) ||
      !bf16_map(&tm_x, x, cells * Q, P)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const tcf::Layout L(Q);
  err = cudaFuncSetAttribute(tcf::ssd_chunk_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.bytes);
  if (err != cudaSuccess) return (int)err;
  tcf::ssd_chunk_bf16_kernel<<<cells < sms ? cells : sms, tcf::THREADS,
                               L.bytes, static_cast<cudaStream_t>(stream)>>>(
      tm_c, tm_b, tm_x, static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(states), cells, Q, N, P);
  return (int)cudaGetLastError();
}

// fp32 x, b, c; Q <= 2048: the CUDA-core form.
extern "C" int ssd_intra_chunk_fp32_launch(const void* x, const void* a,
                                           const void* b, const void* c,
                                           void* y, void* states, int cells,
                                           int Q, int N, int P, void* stream) {
  return launch<float>(x, a, b, c, y, states, cells, Q, N, P,
                       static_cast<cudaStream_t>(stream));
}
