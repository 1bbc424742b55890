// Shared device helpers for the attention kernels of repro_torch.
//
// The CUDA-core forms (an fp32 query; fp32 operands, or int8 K/V
// converted to fp32 while staged) keep their sums in fp32. K/V rows
// staged in shared memory are padded by KV_ROW_PAD elements: with E a
// multiple of 4 that makes a row 4E + 16 bytes, so the 16-byte reads of
// one warp, each on its own row, fall on distinct banks. The bf16 forms
// run on the tensor cores (mma.cuh, decode_tc.cuh, flash_tile.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace repro {

constexpr int KV_TILE = 64;     // kv rows per tile (policy.KV_TILE)
constexpr int KV_ROW_PAD = 4;   // policy.KV_ROW_PAD
constexpr float NEG_INF = -1e30f;

// Four consecutive elements of T, moved as one 16-byte word.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copy `rows` rows of E elements from global memory (row stride E) into
// shared memory (row stride E + KV_ROW_PAD); rows in [rows, zero_to) are
// zero-filled so a masked column never multiplies stale bytes.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows,
                                           int zero_to, int E) {
  using V = typename Vec4<T>::type;
  const int chunks = E / 4;
  const int ld = E + KV_ROW_PAD;
  for (int i = threadIdx.x; i < zero_to * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 4;
    V val;
    if (r < rows) {
      val = *reinterpret_cast<const V*>(src + (size_t)r * E + c);
    } else {
      memset(&val, 0, sizeof(V));
    }
    *reinterpret_cast<V*>(dst + r * ld + c) = val;
  }
}

// Logical kv rows [col0, col0 + rows) of one kv head, gathered from a page
// pool through one sequence's page table: logical row `pos` lives in
// physical page table[pos / page_size], row pos % page_size, of
// `head_pool` (that head's pages, each page_size rows of E elements). The
// rows land in shared memory at stride E + KV_ROW_PAD; rows in
// [rows, zero_to) are zero-filled, so pages past kv_len are never read.
template <typename T>
__device__ __forceinline__ void stage_paged_rows(T* dst, const T* head_pool,
                                                 const int* table,
                                                 int page_size, int col0,
                                                 int rows, int zero_to,
                                                 int E) {
  using V = typename Vec4<T>::type;
  const int chunks = E / 4;
  const int ld = E + KV_ROW_PAD;
  for (int i = threadIdx.x; i < zero_to * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 4;
    V val;
    if (r < rows) {
      const int pos = col0 + r;
      const int page = table[pos / page_size];
      val = *reinterpret_cast<const V*>(
          head_pool + ((size_t)page * page_size + pos % page_size) * E + c);
    } else {
      memset(&val, 0, sizeof(V));
    }
    *reinterpret_cast<V*>(dst + r * ld + c) = val;
  }
}

// Four int8 values packed in a 32-bit word, converted to fp32.
__device__ __forceinline__ float4 q8x4(unsigned w) {
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}

// Sixteen int8 values (one 16-byte load) stored as fp32 at dst.
__device__ __forceinline__ void store_q8x16(float* dst, uint4 u) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = q8x4(u.x);
  d[1] = q8x4(u.y);
  d[2] = q8x4(u.z);
  d[3] = q8x4(u.w);
}

// One tile's K and V rows of an int8 cache, converted to fp32 in
// registers and stored at stride E + KV_ROW_PAD; rows in [rows, zero_to)
// are zero-filled. Row r of the tile starts at element row_off(r) of `k`
// and of `v`. Each thread moves 16 values with one 16-byte load
// (E % 16 == 0) and issues BATCH loads of K and as many of V before it
// converts and stores any, so that many loads of a thread are in flight
// at once and a tile waits on fewer round trips to memory.
template <int BATCH, typename RowOff>
__device__ __forceinline__ void stage_q8_kv(float* Kd, float* Vd,
                                            const int8_t* k, const int8_t* v,
                                            RowOff row_off, int rows,
                                            int zero_to, int E) {
  const int chunks = E / 16;
  const int ld = E + KV_ROW_PAD;
  const int n = zero_to * chunks;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * blockDim.x) {
    uint4 ku[BATCH], vu[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / chunks, c = (i - r * chunks) * 16;
      ku[b] = vu[b] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && r < rows) {
        const size_t off = row_off(r) + c;
        ku[b] = *reinterpret_cast<const uint4*>(k + off);
        vu[b] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < n) {
        const int r = i / chunks, c = (i - r * chunks) * 16;
        store_q8x16(Kd + r * ld + c, ku[b]);
        store_q8x16(Vd + r * ld + c, vu[b]);
      }
    }
  }
}

// Row offsets for stage_q8_kv and decode_tc.cuh: rows of a dense cache
// (row stride E) ...
struct DenseRows {
  int E;
  __device__ __forceinline__ size_t operator()(int r) const {
    return (size_t)r * E;
  }
  // the index of row r's scale in the (b, kv head)'s row of the (BH, S)
  // per-row scales: the row itself
  __device__ __forceinline__ int scale(int r) const { return r; }
};

// ... and logical rows col0 + r of one kv head's pages, through one
// sequence's page table (as stage_paged_rows reads them).
struct PagedRows {
  const int* table;
  int page_size, col0, E;
  // the index of row r's scale in the kv head's row of the (Hkv, P)
  // per-page scales: the physical page that holds logical row col0 + r
  __device__ __forceinline__ int scale(int r) const {
    return table[(col0 + r) / page_size];
  }
  __device__ __forceinline__ size_t operator()(int r) const {
    const int pos = col0 + r;
    return ((size_t)table[pos / page_size] * page_size + pos % page_size) *
           E;
  }
};

// The type a K/V tile is held in shared memory: the storage type, or fp32
// for int8 storage (converted while staging).
template <typename T, typename KV> struct TileOf { using type = T; };
template <typename T> struct TileOf<T, int8_t> { using type = float; };

// Shared-memory floats a kernel reserves for one tile's K and V scales:
// 2 * KV_TILE for int8 storage, none otherwise.
template <typename KV> __host__ __device__ constexpr int scale_floats() {
  return std::is_same<KV, int8_t>::value ? 2 * KV_TILE : 0;
}

// Per-page scales of one tile of logical rows [col0, col0 + rows), read
// through the page table: KS[c] = k_scales[table[(col0 + c) / page]] (the
// kv head's row of the (Hkv, P) side-table), likewise VS; 0 past `rows`.
__device__ __forceinline__ void stage_page_scales(float* KS, float* VS,
                                                  const float* ks_head,
                                                  const float* vs_head,
                                                  const int* table,
                                                  int page_size, int col0,
                                                  int rows) {
  for (int c = threadIdx.x; c < KV_TILE; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    if (c < rows) {
      const int page = table[(col0 + c) / page_size];
      a = ks_head[page];
      b = vs_head[page];
    }
    KS[c] = a;
    VS[c] = b;
  }
}

// Q block of `rows` rows into shared memory as fp32, row stride E.
template <typename T>
__device__ __forceinline__ void stage_q(float* dst, const T* src, int rows,
                                        int E) {
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    dst[i] = to_float(src[i]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dot products of one staged K row (column `c` of a score tile) with
// `nr` Q rows rg, rg + rstep, ... held fp32 in shared memory.
template <int MAXR, typename T>
__device__ __forceinline__ void qk_dots(float (&acc)[MAXR], const float* Qs,
                                        const T* krow, int E, int nr,
                                        int rg, int rstep) {
#pragma unroll
  for (int i = 0; i < MAXR; ++i) acc[i] = 0.f;
  for (int e = 0; e < E; e += 4) {
    const float4 kv = load4(krow + e);
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      if (i < nr) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (rg + i * rstep) * E + e);
        acc[i] = fmaf(qv.x, kv.x, acc[i]);
        acc[i] = fmaf(qv.y, kv.y, acc[i]);
        acc[i] = fmaf(qv.z, kv.z, acc[i]);
        acc[i] = fmaf(qv.w, kv.w, acc[i]);
      }
    }
  }
}

// acc[i][0..3] = sum_{j in [0, n)} P[r_i][j] * V[j][ce..ce+3] for the rows
// r_i = rg + i * rstep (i < nr) of a probability block P (fp32, row
// stride ldp) and V rows staged at stride E + KV_ROW_PAD. n % 4 == 0.
template <int MAXR, typename T>
__device__ __forceinline__ void pv_sums(float (&acc)[MAXR][4], const float* P,
                                        int ldp, const T* V, int n, int E,
                                        int ce, int nr, int rg, int rstep) {
  const int ld = E + KV_ROW_PAD;
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  for (int j = 0; j < n; j += 4) {
    const float4 v0 = load4(V + (j + 0) * ld + ce);
    const float4 v1 = load4(V + (j + 1) * ld + ce);
    const float4 v2 = load4(V + (j + 2) * ld + ce);
    const float4 v3 = load4(V + (j + 3) * ld + ce);
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      if (i < nr) {
        const float4 p =
            *reinterpret_cast<const float4*>(P + (rg + i * rstep) * ldp + j);
        acc[i][0] = fmaf(p.w, v3.x, fmaf(p.z, v2.x, fmaf(p.y, v1.x, fmaf(p.x, v0.x, acc[i][0]))));
        acc[i][1] = fmaf(p.w, v3.y, fmaf(p.z, v2.y, fmaf(p.y, v1.y, fmaf(p.x, v0.y, acc[i][1]))));
        acc[i][2] = fmaf(p.w, v3.z, fmaf(p.z, v2.z, fmaf(p.y, v1.z, fmaf(p.x, v0.z, acc[i][2]))));
        acc[i][3] = fmaf(p.w, v3.w, fmaf(p.z, v2.w, fmaf(p.y, v1.w, fmaf(p.x, v0.w, acc[i][3]))));
      }
    }
  }
}

// Second pass of the split-KV decode kernels (B4, B6): one block per
// (b, kv head) row merges the n_split partial (m, l, acc) triples:
// M = max m, L = sum l e^(m - M), O = sum acc e^(m - M) / L, with L == 0
// (a row that saw no key) dividing by 1.
template <typename T>
__global__ void split_combine_kernel(const float* __restrict__ m_part,
                                     const float* __restrict__ l_part,
                                     const float* __restrict__ acc_part,
                                     T* __restrict__ o, int G, int E,
                                     int n_split) {
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < G * E; i += blockDim.x) {
    const int g = i / E, e = i - g * E;
    float m_max = NEG_INF;
    for (int sp = 0; sp < n_split; ++sp)
      m_max = fmaxf(m_max, m_part[((size_t)bh * n_split + sp) * G + g]);
    float l = 0.f, num = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t row = ((size_t)bh * n_split + sp) * G + g;
      const float w = expf(m_part[row] - m_max);
      l = fmaf(l_part[row], w, l);
      num = fmaf(acc_part[row * E + e], w, num);
    }
    l = l == 0.f ? 1.f : l;
    store(o + ((size_t)bh * G + g) * E + e, num / l);
  }
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
