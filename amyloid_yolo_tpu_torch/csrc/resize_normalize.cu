// K1: nearest resize + scale to [0, 1], uint8 NHWC -> bf16 NHWC.
//
// Replaces the reference package's Pallas kernel
// pallas/preprocess_kernel.py:resize_normalize (the pl.pallas_call at :90,
// body _kernel at :53).  That kernel pre-gathers rows, selects columns with
// a one-hot matmul and bitcasts uint8 through int8: TPU workarounds.  Here
// it is a direct gather, one thread per output pixel (3 channels).
//
//   out[b, i, j, c] = bf16_rn(float(src[b, ri[i], ci[j], c]) / 255.0f)
//
// The index tables ri/ci come from the host (ops/preprocess.nearest_indices)
// as int32 device arrays; nothing re-derives floor(i*S/dst) in float here.
// The division is IEEE (this file is built without --use_fast_math).
//
// Bound on an H100: memory.  The selected columns lie about 11 bytes apart
// in a 1536-wide source row, so every 32-byte sector of the dst selected
// rows is fetched: 416*1536*3 = 1.92 MB read and 416*416*3*2 = 1.04 MB
// written per 1536^2 tile, ~0.88 us per tile at 3.35 TB/s.  The design does
// nothing more about it than to touch each selected row once, in order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// grid = (ceil(Wd / 128), Hd, B): one block row per output row, so a
// thread finds its source pixel without integer division.
__global__ void resize_normalize_kernel(const uint8_t* __restrict__ src,
                                        const int* __restrict__ ri,
                                        const int* __restrict__ ci,
                                        __nv_bfloat16* __restrict__ out,
                                        int Hs, int Ws, int Hd, int Wd) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wd) return;
  const int i = blockIdx.y;
  const long long b = blockIdx.z;
  const uint8_t* s = src + ((b * Hs + ri[i]) * Ws + ci[j]) * 3;
  __nv_bfloat16* o = out + ((b * Hd + i) * Wd + j) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __float2bfloat16_rn((float)s[c] / 255.0f);
  }
}

}  // namespace

extern "C" int amyolo_resize_normalize(const void* src, const void* ri,
                                       const void* ci, void* out, int B,
                                       int Hs, int Ws, int Hd, int Wd,
                                       void* stream) {
  const int threads = 128;
  if (B > 0 && Hd > 0 && Wd > 0) {
    const dim3 grid((unsigned)((Wd + threads - 1) / threads), (unsigned)Hd, (unsigned)B);
    resize_normalize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, (const int*)ri, (const int*)ci,
        (__nv_bfloat16*)out, Hs, Ws, Hd, Wd);
  }
  return (int)cudaGetLastError();
}
