// Tensor-core and asynchronous-copy helpers for the bf16 prefill kernels
// (B1's and B2's bf16 forms in mas_attention.cu, B3's in
// flash_attention.cu, B5's in paged_prefill_attention.cu).
//
// B1's and B2's products are mma.sync.aligned.m16n8k16 in bf16 with fp32
// accumulation, fed by ldmatrix from shared memory; B3's and B5's are
// wgmma (below, and the tile step they share in flash_tile.cuh).
// In an m16n8k16 fragment, lane l holds rows
// g = l / 4 and g + 8 and the column pair 2 (l % 4), 2 (l % 4) + 1 (A and
// the accumulator), or that pair of the k dimension for column g (B).
//
// bf16 tiles in shared memory have no pad: the 16-byte chunk c of row r
// sits at chunk c ^ (r & 7), so the eight rows one ldmatrix matrix reads
// fall on eight distinct chunks of 128 bytes and no two share a bank.
// Tiles are staged 16 bytes a thread, by cp.async or through registers
// (ld_rows early, st_rows late), so a tile's copy is in flight while the
// tensor cores work on the previous one.
//
// P enters P·V as two bf16 products, P = hi + lo with hi = bf16(P) and
// lo = bf16(P - hi): one bf16 rounding of P (up to 2^-8 of it) moves an
// output row by about as much as the 4e-3 a row that the kernels are held
// to (tests/test_torch_tc_rounding.py); the split leaves about 2^-16.
#pragma once

#include "common.cuh"

namespace repro {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The same with only the first src_bytes (0 or 16) read and the rest of
// the 16 bytes zero-filled: a row past the live ones is stored as zeros.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Four bytes by cp.async (through L1), of which only the first src_bytes
// (0 or 4) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for a count known only at run time (at most 7 is waited for
// exactly; a larger count waits for 7, which is only stricter).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// --- barriers between producer and consumer warps ---------------------------

// Named barrier `id` (1-15; 0 is __syncthreads) over `n` threads: wait for
// all of them (sync) or count this warp in and go on (arrive).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A shared-memory mbarrier at address bar expecting `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// This thread's arrival on bar once all its earlier cp.async copies have
// landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// This thread's arrival on bar (release: its earlier writes to shared
// memory are seen by a thread that then waits on the phase).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Byte offset of element (row, col) in a swizzled bf16 tile of E columns.
template <int E>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * (E * 2) + ((((col >> 3) ^ (row & 7))) << 4) + ((col & 7) << 1);
}

// Rows [0, rows) of a bf16 matrix with row stride E into the swizzled tile
// at shared address dst, by all `nthreads` threads of the block.
template <int E>
__device__ __forceinline__ void cp_rows(uint32_t dst, const bf16* src,
                                        int rows, int nthreads) {
  constexpr int CHUNKS = E / 8;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += nthreads) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    cp_async16(dst + swz<E>(r, c * 8), src + (size_t)r * E + c * 8);
  }
}

// Rows [0, rows) of a bf16 matrix with row stride E, as the 16-byte
// chunks thread t moves: chunk t + j nthreads goes to v[j]. ld_rows loads
// them into registers (in flight until st_rows needs them); st_rows stores
// them into the swizzled tile at shared address dst.
template <int E, int CH>
__device__ __forceinline__ void ld_rows(uint4 (&v)[CH], const bf16* src,
                                        int nthreads) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int i = threadIdx.x + j * nthreads;
    v[j] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(i / (E / 8)) * E) + i % (E / 8));
  }
}

template <int E, int CH>
__device__ __forceinline__ void st_rows(uint32_t dst, const uint4 (&v)[CH],
                                        int nthreads) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int i = threadIdx.x + j * nthreads;
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + swz<E>(i / (E / 8), i % (E / 8) * 8)),
                 "r"(v[j].x), "r"(v[j].y), "r"(v[j].z), "r"(v[j].w)
                 : "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: a 16x16 (row-major fragment), b 16x8 (column fragment).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 pairs (x in the low half) hi = bf16(x, y) and
// lo = bf16((x, y) - hi).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  memcpy(&hi, &h, 4);
  memcpy(&lo, &l, 4);
}


// --- wgmma (Hopper's warpgroup products) -----------------------------------
//
// A warpgroup of 4 warps computes D (64 x N) += A (64 x 16) B (16 x N): A
// from registers (warp w holds rows 16 w .. 16 w + 15 as an m16n8k16 A
// fragment), B from shared memory through a descriptor, D in registers
// (warp w's rows, each n8 block as an m16n8 accumulator). B's tiles use
// the 128-byte swizzle: a tile of R rows is kept as 64-element column
// halves of R rows x 128 bytes, chunk c of row r at chunk c ^ (r & 7),
// each half 1024-byte aligned (sw128).

// Byte offset of element (row, col) in a 128-byte-swizzled bf16 tile of R
// rows.
template <int R>
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return (col >> 6) * (R * 128) + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// Rows [0, R) of a bf16 matrix with row stride E into the sw128 tile at
// shared address dst, 16 bytes a thread by cp.async.
template <int E, int R>
__device__ __forceinline__ void cp_rows_sw128(uint32_t dst, const bf16* src,
                                              int nthreads) {
  constexpr int CHUNKS = E / 8;
  for (int i = threadIdx.x; i < R * CHUNKS; i += nthreads) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    cp_async16(dst + sw128<R>(r, c * 8), src + (size_t)r * E + c * 8);
  }
}

// The descriptor of a 128-byte-swizzled operand at shared address addr:
// lbo and sbo in bytes (sbo: between groups of 8 rows; lbo: between the
// 64-element halves of an MN-major operand).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Make cp.async's (generic-proxy) writes to shared memory visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma reads its A registers and updates its accumulators
// asynchronously, between the instruction and wgmma_wait, which the
// compiler cannot see. fence_regs pins a register array at a point:
// before the wgmma_fence (no write moves below it) and after the
// wgmma_wait (no read moves above it, and the A registers are not reused
// while a product may still read them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

}  // namespace tc
}  // namespace repro
