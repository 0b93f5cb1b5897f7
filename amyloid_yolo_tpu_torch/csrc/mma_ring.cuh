// Pieces shared by K2 (conv_block.cu) and K3 (int8_block.cu): the geometry
// of a block (8 warps, each owning 64 output pixels), 16-byte cp.async
// copies into a ring of shared-memory stages, ldmatrix, and the ring's
// pipeline.  Both kernels feed mma.sync fragments whose byte layout is the
// same: m16n8k16 bf16 and m16n8k32 s8 take A as 16 rows x 32 bytes and B
// as 8 columns x 32 bytes, four bytes a register, so one ldmatrix.x4 of
// .b16 8x8 matrices loads an A fragment or the B fragments of two n8 tiles
// for either type.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace mma_ring {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpM = 64;               // a warp's tile: 64 pixels x 8*NT channels
constexpr int kMT = kWarpM / 16;
constexpr int kMaxSmem = 232448;         // shared memory of one block
constexpr int kSmPerSm = 233472;         // of one SM
constexpr int kSmemReserved = 1024;      // reserved per resident block

// 1x1 ring stages: 3, or 4 for 64-channel warps (whose 3x3 needs the bytes)
constexpr int ring_stages(int warp_n) { return warp_n == 64 ? 4 : 3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src-size 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Position in a GEMM walked as (m chunk, n chunk, tap, k slice), k fastest.
struct Cursor {
  int k = 0, tap = 0, nc = 0, mc = 0;
  __device__ __forceinline__ void next(int kpt, int taps, int ncn) {
    if (++k < kpt) return;
    k = 0;
    if (++tap < taps) return;
    tap = 0;
    if (++nc < ncn) return;
    nc = 0;
    ++mc;
  }
};

// A cp.async ring of S stages over `steps` k-slices: load(slot) issues the
// next slice's copies into a slot, compute(slot) consumes the next slice.
// One barrier per slice: after it, slice s has landed for every thread and
// every warp is done with slice s - 1, whose slot the load of slice
// s + S - 1 reuses.  With kAsyncRead the slices are read through the async
// proxy (wgmma's shared-memory operands): each thread fences its landed
// copies to that proxy before the barrier.
template <int S, bool kAsyncRead = false, class Load, class Compute>
__device__ __forceinline__ void pipeline(int steps, Load&& load, Compute&& compute) {
#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  int ls = S - 1, cs = 0;  // slots of the next load and the next compute
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();
    if constexpr (kAsyncRead) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + S - 1 < steps) load(ls);
    cp_async_commit();
    compute(cs);
    ls = ls + 1 == S ? 0 : ls + 1;
    cs = cs + 1 == S ? 0 : cs + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// m16 tiles of a warp whose first pixel is `base`, of `m` pixels in all
__device__ __forceinline__ int m16_tiles(int m, int base) {
  return max(0, min(kMT, (m - base + 15) / 16));
}

// `set()` once per CUDA device, on the device current at the call; returns
// that device's result.  A kernel attribute such as the dynamic shared-memory
// limit belongs to the context of the device that was current when it was
// set, so a second card needs its own call.  Each caller's lambda has its
// own type, so each gets its own flags.
constexpr int kMaxDevices = 64;

template <class F>
cudaError_t once_per_device(F set) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] { result[dev] = set(); });
  return result[dev];
}

}  // namespace mma_ring
