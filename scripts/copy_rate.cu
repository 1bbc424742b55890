// How fast one thread block pulls L2-resident data into shared memory, by
// copy mechanism: the question behind the staging of the bf16 prefill
// kernels (csrc/mas_attention.cu, csrc/flash_attention.cu). Each block
// copies 8 KB stages from a 1 MB window (L2-resident) into a ring in
// shared memory, waits for each stage, touches it and refills it:
//   mode 0: cp.async.cg, 16 bytes a thread, `stages` deep;
//   mode 1: one cp.async.bulk (TMA) of 8 KB a stage, mbarrier, `stages` deep;
//   mode 2: ld.global into registers, then st.shared (synchronous);
//   mode 3: ld.global two stages ahead into registers, st.shared later.
// Built and run by scripts/copy_rate.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGE = 8192;

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n W: mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra W;\n}" ::"r"(bar), "r"(parity) : "memory");
}

template <int MODE>
__global__ void copy_kernel(const uint4* __restrict__ src, int iters,
                            int stages, int window, long long* clocks,
                            int* sink) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(8) uint64_t bar[8];
  const int tid = threadIdx.x, nt = blockDim.x, per = STAGE / 16;
  const uint32_t base = sa(sm);
  auto chunk = [&](int it) {
    return src + (size_t)((it + blockIdx.x * 7) % window) * per;
  };
  if (MODE == 1 && tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared.b64 [%0], 1;" ::"r"(sa(&bar[s])));
    asm volatile("fence.mbarrier_init.release.cluster;");
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int slot = it % stages;
    if (MODE == 0) {
      for (int i = tid; i < per; i += nt)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         base + slot * STAGE + i * 16),
                     "l"(chunk(it) + i)
                     : "memory");
      asm volatile("cp.async.commit_group;" ::: "memory");
    } else if (tid == 0) {
      const uint32_t b = sa(&bar[slot]);
      asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;" ::"r"(b),
                   "r"(STAGE)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(base + slot * STAGE),
          "l"(chunk(it)), "r"(STAGE), "r"(b)
          : "memory");
    }
  };
  int acc = 0;
  const long long t0 = clock64();
  if (MODE >= 2) {   // 256 threads, two 16-byte chunks each a stage
    uint4 r[2][2];
    const int ahead = MODE == 3 ? 2 : 0;
    for (int j = 0; j < ahead; ++j) {
      r[j][0] = chunk(j)[tid];
      r[j][1] = chunk(j)[tid + nt];
    }
    for (int it = 0; it < iters; ++it) {
      uint4* d = reinterpret_cast<uint4*>(sm + (it % 2) * STAGE);
      if (MODE == 2) {
        r[0][0] = chunk(it)[tid];
        r[0][1] = chunk(it)[tid + nt];
      }
      const int j = MODE == 3 ? it & 1 : 0;
      d[tid] = r[j][0];
      d[tid + nt] = r[j][1];
      if (MODE == 3) {
        r[j][0] = chunk(it + 2)[tid];
        r[j][1] = chunk(it + 2)[tid + nt];
      }
      __syncthreads();
      acc += reinterpret_cast<int*>(d)[tid];
    }
  } else {
    for (int s = 0; s < stages - 1; ++s) issue(s);
    for (int it = 0; it < iters; ++it) {
      if (MODE == 1) {
        wait_parity(sa(&bar[it % stages]), (it / stages) & 1);
      } else if (stages == 2) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      }
      __syncthreads();
      acc += reinterpret_cast<int*>(sm + (it % stages) * STAGE)[tid];
      issue(it + stages - 1);
    }
    if (MODE == 0) {
      asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
      for (int it = iters; it < iters + stages - 1; ++it)
        wait_parity(sa(&bar[it % stages]), (it / stages) & 1);
    }
  }
  const long long t1 = clock64();
  if (tid == 0) clocks[blockIdx.x] = t1 - t0;
  if (acc == 12345) sink[0] = acc;   // keeps the loads alive
}

}  // namespace

// Runs `mode` twice (the first warms up) on `blocks` blocks of `threads`;
// clocks[b] gets block b's SM clocks of the second run, *ms its time.
// mode 0 and 1 take stages 2 or 3; modes 2 and 3 take 256 threads.
extern "C" int copy_rate_run(int mode, const void* src, int blocks,
                             int threads, int iters, int stages, int window,
                             long long* clocks, int* sink, float* ms) {
  void (*k)(const uint4*, int, int, int, long long*, int*) =
      mode == 0 ? copy_kernel<0>
                : mode == 1 ? copy_kernel<1>
                            : mode == 2 ? copy_kernel<2> : copy_kernel<3>;
  const size_t smem = (size_t)(mode >= 2 ? 2 : stages) * STAGE;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  k<<<blocks, threads, smem>>>(static_cast<const uint4*>(src), iters, stages,
                               window, clocks, sink);
  cudaEventRecord(a);
  k<<<blocks, threads, smem>>>(static_cast<const uint4*>(src), iters, stages,
                               window, clocks, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return (int)cudaGetLastError();
}
