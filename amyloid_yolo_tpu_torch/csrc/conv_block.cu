// K2: one BN-folded Darknet residual unit in one launch, bf16 NHWC.
//
//   h = bf16(leaky(conv1x1(x) + b1))          f32 accumulate, f32 bias
//   y = bf16(float(x) + leaky(conv3x3(h) + b2))   zero-padded h, f32 add
//
// Replaces the reference package's Pallas kernel
// pallas/conv_block.py:fused_residual_block (the pl.pallas_call at :107,
// body _block_kernel at :50).  The TPU kernel holds a whole image in VMEM;
// a Hopper block has at most 227 KB of shared memory, so here each block
// owns (image, strip of output rows, tile of output channels):
//
//   1. the 1x1 conv for the strip plus a one-row halo above and below goes
//      into shared memory as bf16 (after the f32 bias and leaky), with a
//      zero column on each side.  Hidden rows outside the image are written
//      as zero: the hidden map is masked, not x, because 1x1(0) =
//      leaky(b1) != 0;
//   2. the 3x3 conv reads the nine taps from shared memory, then the f32
//      epilogue adds b2, applies leaky, adds the residual x in f32 and
//      rounds to bf16.
//
// Both convs are implicit GEMMs on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate); each warp owns a 64-pixel by
// 32-channel tile and loads the fragments of the next k-step before it
// issues the MMAs of the current one.  Pixel rows outside the map load as
// zero and are not stored, so W need not be a multiple of 16.  Hidden
// pixels are stored with 8 bf16 of padding, which makes the fragment loads
// free of bank conflicts.
//
// Output-channel tiling recomputes the 1x1: with oc_tile = 128 a 1024-ch
// unit computes its 1x1 eight times (1.7x the unit's FLOPs), a 512-ch unit
// four times (1.3x); units of <= 128 channels compute it once.  The
// wrapper picks strip and oc_tile.
//
// Bound on an H100: compute for the deeper units (20*H*W*C*C/2 = 1.77 GFLOP
// per image at every stage of YOLOv3-416, ~1.8 us at 989 TFLOP/s); the
// 208^2 x 64 unit is memory-bound (4*H*W*C bytes per image, ~3.3 us).  This
// version stages no weights in shared memory and uses neither cp.async/TMA
// nor wgmma: every warp streams its own weight fragments from L2, which
// keeps it far below the tensor-core peak (PERF.md has its times).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;         // bf16 of padding per hidden pixel
constexpr float kSlope = 0.1f;  // LeakyReLU slope

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * kSlope; }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one m16n8k16 tile (PTX ISA fragment layouts:
// a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t..], D[g+8][2t..]}).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's tile: kMT m16 tiles (16*kMT pixels) by 4 n8 tiles (32 channels).
constexpr int kMT = 4;
constexpr int kTileM = 16 * kMT;

struct Frags {
  uint32_t a[kMT][4];
  uint32_t b[4][2];
};

__device__ __forceinline__ void mma_tile(float (&acc)[kMT][4][4], const Frags& f) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) mma_bf16(acc[mi][ni], f.a[mi], f.b[ni][0], f.b[ni][1]);
}

// x, y: (B, H, W, C) bf16.  w1t: (C2, C) bf16 (out-channel major, input
// channel contiguous).  w2t: (9, C, C2) bf16, tap = 3*di + dj.  b1: (C2,)
// f32.  b2: (C,) f32.  grid = (ceil(H/strip) * C/oc_tile, B).  C2 % 32 == 0.
// Each k-loop loads the fragments of step s+1 before it issues the MMAs of
// step s, so the weight loads from L2 overlap the tensor-core work.
__global__ void __launch_bounds__(kThreads)
fused_residual_block_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w1t,
                            const float* __restrict__ b1,
                            const __nv_bfloat16* __restrict__ w2t,
                            const float* __restrict__ b2,
                            __nv_bfloat16* __restrict__ y,
                            int H, int W, int C, int C2, int strip, int oc_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hid = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int n_oc = C / oc_tile;
  const int r0 = (blockIdx.x / n_oc) * strip;
  const int oc0 = (blockIdx.x % n_oc) * oc_tile;
  const long long b = blockIdx.y;
  const int rows = min(strip, H - r0);  // output rows of this block
  const int hrows = rows + 2;           // hidden rows, halo included
  const int Wp = W + 2;                 // hidden columns, zero pad included
  const int cs = C2 + kPad;             // hidden pixel stride (elements)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* xb = x + b * H * W * C;

  // zero padding columns 0 and W+1 of every hidden row
  for (int idx = threadIdx.x; idx < hrows * 2 * (C2 / 2); idx += kThreads) {
    const int pair = idx % (C2 / 2);
    const int rc = idx / (C2 / 2);
    const int col = (rc & 1) ? (W + 1) : 0;
    reinterpret_cast<uint32_t*>(hid + ((rc >> 1) * Wp + col) * cs)[pair] = 0u;
  }

  // ---- phase 1: hidden = leaky(x @ w1 + b1) for image rows r0-1 .. r0+rows
  const int npix1 = hrows * W;
  const int nt1 = C2 / 32;
  for (int task = warp; task < ((npix1 + kTileM - 1) / kTileM) * nt1; task += kWarps) {
    const int pm = (task / nt1) * kTileM, pn = (task % nt1) * 32;
    const __nv_bfloat16* arow[kMT][2];
    bool aval[kMT][2];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = pm + mi * 16 + hh * 8 + g;
        const int ir = r0 - 1 + p / W;
        aval[mi][hh] = p < npix1 && ir >= 0 && ir < H;
        arow[mi][hh] = (aval[mi][hh] ? xb + ((long long)ir * W + p % W) * C : xb) + 2 * t;
      }
    const __nv_bfloat16* wrow[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) wrow[ni] = w1t + (long long)(pn + ni * 8 + g) * C + 2 * t;
    auto load = [&](int k0, Frags& f) {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        f.a[mi][0] = aval[mi][0] ? ld32(arow[mi][0] + k0) : 0u;
        f.a[mi][1] = aval[mi][1] ? ld32(arow[mi][1] + k0) : 0u;
        f.a[mi][2] = aval[mi][0] ? ld32(arow[mi][0] + k0 + 8) : 0u;
        f.a[mi][3] = aval[mi][1] ? ld32(arow[mi][1] + k0 + 8) : 0u;
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        f.b[ni][0] = ld32(wrow[ni] + k0);
        f.b[ni][1] = ld32(wrow[ni] + k0 + 8);
      }
    };
    float acc[kMT][4][4] = {};
    Frags f0, f1;
    load(0, f0);
    for (int k0 = 0; k0 < C; k0 += 32) {  // C % 32 == 0: steps come in pairs
      load(k0 + 16, f1);
      mma_tile(acc, f0);
      if (k0 + 32 < C) load(k0 + 32, f0);
      mma_tile(acc, f1);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = pm + mi * 16 + hh * 8 + g;
        if (p >= npix1) continue;
        const int hr = p / W, col = p % W;
        const int ir = r0 - 1 + hr;
        const bool inside = ir >= 0 && ir < H;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = pn + ni * 8 + 2 * t;
          const float v0 = leaky(acc[mi][ni][hh * 2 + 0] + b1[n]);
          const float v1 = leaky(acc[mi][ni][hh * 2 + 1] + b1[n + 1]);
          const __nv_bfloat162 hv = inside ? __floats2bfloat162_rn(v0, v1)
                                           : __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(hid + (hr * Wp + col + 1) * cs + n) = hv;
        }
      }
  }
  __syncthreads();

  // ---- phase 2: y = x + leaky(conv3x3(hidden) + b2) for this block's rows
  const int npix2 = rows * W;
  const int nt2 = oc_tile / 32;
  const int kpt = C2 / 16;    // k-steps per tap
  const int steps = 9 * kpt;  // even, since C2 % 32 == 0
  for (int task = warp; task < ((npix2 + kTileM - 1) / kTileM) * nt2; task += kWarps) {
    const int pm = (task / nt2) * kTileM, pn = oc0 + (task % nt2) * 32;
    int hbase[kMT][2];  // hidden offset of tap (0, 0) for each loaded pixel row
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        int p = pm + mi * 16 + hh * 8 + g;
        if (p >= npix2) p = 0;  // computed, never stored
        hbase[mi][hh] = ((p / W) * Wp + p % W) * cs + 2 * t;
      }
    auto load = [&](int s, Frags& f) {
      const int tap = s / kpt;
      const int k0 = (s - tap * kpt) * 16;
      const int toff = ((tap / 3) * Wp + tap % 3) * cs + k0;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const __nv_bfloat16* h0 = hid + hbase[mi][0] + toff;
        const __nv_bfloat16* h1 = hid + hbase[mi][1] + toff;
        f.a[mi][0] = ld32(h0);
        f.a[mi][1] = ld32(h1);
        f.a[mi][2] = ld32(h0 + 8);
        f.a[mi][3] = ld32(h1 + 8);
      }
      const __nv_bfloat16* wtap = w2t + (long long)tap * C * C2 + k0 + 2 * t;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* wr = wtap + (long long)(pn + ni * 8 + g) * C2;
        f.b[ni][0] = ld32(wr);
        f.b[ni][1] = ld32(wr + 8);
      }
    };
    float acc[kMT][4][4] = {};
    Frags f0, f1;
    load(0, f0);
    for (int s = 0; s < steps; s += 2) {
      load(s + 1, f1);
      mma_tile(acc, f0);
      if (s + 2 < steps) load(s + 2, f0);
      mma_tile(acc, f1);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = pm + mi * 16 + hh * 8 + g;
        if (p >= npix2) continue;
        const long long off = ((b * H + r0 + p / W) * W + p % W) * C;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = pn + ni * 8 + 2 * t;
          const float v0 = leaky(acc[mi][ni][hh * 2 + 0] + b2[n]);
          const float v1 = leaky(acc[mi][ni][hh * 2 + 1] + b2[n + 1]);
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off + n);
          *reinterpret_cast<__nv_bfloat162*>(y + off + n) = __floats2bfloat162_rn(
              __bfloat162float(xv.x) + v0, __bfloat162float(xv.y) + v1);
        }
      }
  }
}

}  // namespace

extern "C" int amyolo_conv_block_smem_bytes(int W, int C2, int strip) {
  return (strip + 2) * (W + 2) * (C2 + kPad) * 2;
}

extern "C" int amyolo_fused_residual_block(const void* x, const void* w1t,
                                           const void* b1, const void* w2t,
                                           const void* b2, void* y, int B, int H,
                                           int W, int C, int C2, int strip,
                                           int oc_tile, void* stream) {
  const int smem = amyolo_conv_block_smem_bytes(W, C2, strip);
  cudaError_t err = cudaFuncSetAttribute(
      fused_residual_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((H + strip - 1) / strip) * (C / oc_tile)), (unsigned)B);
  fused_residual_block_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1t, (const float*)b1,
      (const __nv_bfloat16*)w2t, (const float*)b2, (__nv_bfloat16*)y, H, W, C,
      C2, strip, oc_tile);
  return (int)cudaGetLastError();
}
