// K3: one quantized Darknet residual unit in one launch, int8 NHWC in and out.
//
//   h = q(leaky(float(conv1x1(x)) * a1 + b1), inv_s1)   masked to 0 off the image
//   y = q(leaky(float(conv3x3(h)) * a2 + b2) + float(x) * sx, inv_sout)
//   q(v, inv) = clamp(round_half_even(v * inv), -127, 127)
//
// Replaces the reference package's Pallas kernel
// pallas/int8_block.py:fused_residual_block_int8 (the pl.pallas_call at
// :150, body _block_kernel at :60).  The TPU kernel's grid walks (image, row
// strip) and fetches the one-row halos as extra BlockSpecs; here a block
// owns (image, strip of output rows, tile of output channels):
//
//   1. the 1x1 conv for the strip plus a one-row halo above and below goes
//      into shared memory as int8, requantized at s1, with a zero column on
//      each side.  Hidden rows outside the image are written as zero: the
//      hidden map is masked, not x, because 1x1(0) = q(leaky(b1)) != 0;
//   2. the 3x3 conv reads the nine taps from shared memory; the epilogue
//      adds the shortcut x*sx and requantizes at s_out.
//
// Both convs are implicit GEMMs on the tensor cores through
// mma.sync.m16n8k32 (s8 x s8 -> s32, exact).  Each warp owns a 64-pixel by
// 32-channel tile and loads the fragments of the next k-step before it
// issues the MMAs of the current one.  Hidden pixels are stored with 16
// bytes of padding, which makes the fragment loads free of bank conflicts.
//
// Bit-exactness: the products are exact, and every float operation of the
// epilogue is an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn),
// so nvcc cannot contract a*b+c into an FMA (it does by default, and the
// reference rounds the multiply and the add separately).  __float2int_rn
// rounds half to even, as jnp.round does, before the clamp.
//
// Bound on an H100: 20*H*W*C*C/2 int8 operations per image (1.77 GOP at
// every stage of YOLOv3-416, ~0.9 us at 1979 TOP/s) against 2*H*W*C bytes
// (~2.8 us for the 208^2 x 64 unit, which is memory-bound; the deeper units
// are operation-bound).  Like K2, this version stages no weights in shared
// memory and uses neither cp.async/TMA nor wgmma: every warp streams its
// weight fragments from L2.  Output-channel tiles of 128 recompute the
// strip's 1x1 for 512- and 1024-channel units (1.3x and 1.7x the FLOPs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 16;        // bytes of padding per hidden pixel
constexpr float kSlope = 0.1f;  // LeakyReLU slope, f32(0.1)

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : __fmul_rn(v, kSlope);
}

// y = v * a + b with the multiply and the add each rounded
__device__ __forceinline__ float affine(int acc, float a, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

__device__ __forceinline__ int8_t requant(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return (int8_t)max(-127, min(127, q));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one m16n8k32 tile (PTX ISA fragment layouts for .s8:
// a = {A[g][4t..], A[g+8][4t..], A[g][4t+16..], A[g+8][4t+16..]},
// b = {B[4t..][g], B[4t+16..][g]}, d = {D[g][2t..], D[g+8][2t..]}).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's tile: kMT m16 tiles (16*kMT pixels) by 4 n8 tiles (32 channels).
constexpr int kMT = 4;
constexpr int kTileM = 16 * kMT;

struct Frags {
  uint32_t a[kMT][4];
  uint32_t b[4][2];
};

__device__ __forceinline__ void mma_tile(int (&acc)[kMT][4][4], const Frags& f) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) mma_s8(acc[mi][ni], f.a[mi], f.b[ni][0], f.b[ni][1]);
}

// Run `steps` k-steps of 32: load(s, frags) fills the fragments of step s.
// The fragments of step s+1 load before the MMAs of step s issue.
template <typename Load>
__device__ __forceinline__ void k_loop(int (&acc)[kMT][4][4], int steps, Load load) {
  Frags f0, f1;
  load(0, f0);
  for (int s = 0; s < steps; s += 2) {
    if (s + 1 < steps) load(s + 1, f1);
    mma_tile(acc, f0);
    if (s + 2 < steps) load(s + 2, f0);
    if (s + 1 < steps) mma_tile(acc, f1);
  }
}

// x, y: (B, H, W, C) int8.  w1t: (C2, C) int8 (out-channel major, input
// channel contiguous).  w2t: (9, C, C2) int8, tap = 3*di + dj.  a1, b1: (C2,)
// f32.  a2, b2: (C,) f32.  grid = (ceil(H/strip) * C/oc_tile, B).
// C % 64 == 0, so C2 % 32 == 0.
__global__ void __launch_bounds__(kThreads)
fused_residual_block_int8_kernel(const int8_t* __restrict__ x,
                                 const int8_t* __restrict__ w1t,
                                 const float* __restrict__ a1,
                                 const float* __restrict__ b1,
                                 const int8_t* __restrict__ w2t,
                                 const float* __restrict__ a2,
                                 const float* __restrict__ b2,
                                 int8_t* __restrict__ y,
                                 int H, int W, int C, int C2, int strip, int oc_tile,
                                 float sx, float inv_s1, float inv_sout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* hid = reinterpret_cast<int8_t*>(smem_raw);

  const int n_oc = C / oc_tile;
  const int r0 = (blockIdx.x / n_oc) * strip;
  const int oc0 = (blockIdx.x % n_oc) * oc_tile;
  const long long b = blockIdx.y;
  const int rows = min(strip, H - r0);  // output rows of this block
  const int hrows = rows + 2;           // hidden rows, halo included
  const int Wp = W + 2;                 // hidden columns, zero pad included
  const int cs = C2 + kPad;             // hidden pixel stride (bytes)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* xb = x + b * H * W * C;

  // zero padding columns 0 and W+1 of every hidden row
  for (int idx = threadIdx.x; idx < hrows * 2 * (C2 / 4); idx += kThreads) {
    const int word = idx % (C2 / 4);
    const int rc = idx / (C2 / 4);
    const int col = (rc & 1) ? (W + 1) : 0;
    reinterpret_cast<uint32_t*>(hid + ((rc >> 1) * Wp + col) * cs)[word] = 0u;
  }

  // ---- phase 1: hidden = q(leaky(x @ w1 * a1 + b1)) for rows r0-1 .. r0+rows
  const int npix1 = hrows * W;
  const int nt1 = C2 / 32;
  for (int task = warp; task < ((npix1 + kTileM - 1) / kTileM) * nt1; task += kWarps) {
    const int pm = (task / nt1) * kTileM, pn = (task % nt1) * 32;
    const int8_t* arow[kMT][2];
    bool aval[kMT][2];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = pm + mi * 16 + hh * 8 + g;
        const int ir = r0 - 1 + p / W;
        aval[mi][hh] = p < npix1 && ir >= 0 && ir < H;
        arow[mi][hh] = (aval[mi][hh] ? xb + ((long long)ir * W + p % W) * C : xb) + 4 * t;
      }
    const int8_t* wrow[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) wrow[ni] = w1t + (long long)(pn + ni * 8 + g) * C + 4 * t;
    int acc[kMT][4][4] = {};
    k_loop(acc, C / 32, [&](int s, Frags& f) {
      const int k0 = s * 32;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        f.a[mi][0] = aval[mi][0] ? ld32(arow[mi][0] + k0) : 0u;
        f.a[mi][1] = aval[mi][1] ? ld32(arow[mi][1] + k0) : 0u;
        f.a[mi][2] = aval[mi][0] ? ld32(arow[mi][0] + k0 + 16) : 0u;
        f.a[mi][3] = aval[mi][1] ? ld32(arow[mi][1] + k0 + 16) : 0u;
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        f.b[ni][0] = ld32(wrow[ni] + k0);
        f.b[ni][1] = ld32(wrow[ni] + k0 + 16);
      }
    });
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
          char2 hv = make_char2(0, 0);
          if (inside) {
            hv.x = requant(leaky(affine(acc[mi][ni][hh * 2 + 0], a1[n], b1[n])), inv_s1);
            hv.y = requant(leaky(affine(acc[mi][ni][hh * 2 + 1], a1[n + 1], b1[n + 1])), inv_s1);
          }
          *reinterpret_cast<char2*>(hid + (hr * Wp + col + 1) * cs + n) = hv;
        }
      }
  }
  __syncthreads();

  // ---- phase 2: y = q(leaky(conv3x3(hidden) * a2 + b2) + x * sx) for this block's rows
  const int npix2 = rows * W;
  const int nt2 = oc_tile / 32;
  const int kpt = C2 / 32;  // k-steps per tap
  for (int task = warp; task < ((npix2 + kTileM - 1) / kTileM) * nt2; task += kWarps) {
    const int pm = (task / nt2) * kTileM, pn = oc0 + (task % nt2) * 32;
    int hbase[kMT][2];  // hidden offset of tap (0, 0) for each loaded pixel row
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        int p = pm + mi * 16 + hh * 8 + g;
        if (p >= npix2) p = 0;  // computed, never stored
        hbase[mi][hh] = ((p / W) * Wp + p % W) * cs + 4 * t;
      }
    int acc[kMT][4][4] = {};
    k_loop(acc, 9 * kpt, [&](int s, Frags& f) {
      const int tap = s / kpt;
      const int k0 = (s - tap * kpt) * 32;
      const int toff = ((tap / 3) * Wp + tap % 3) * cs + k0;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int8_t* h0 = hid + hbase[mi][0] + toff;
        const int8_t* h1 = hid + hbase[mi][1] + toff;
        f.a[mi][0] = ld32(h0);
        f.a[mi][1] = ld32(h1);
        f.a[mi][2] = ld32(h0 + 16);
        f.a[mi][3] = ld32(h1 + 16);
      }
      const int8_t* wtap = w2t + (long long)tap * C * C2 + k0 + 4 * t;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* wr = wtap + (long long)(pn + ni * 8 + g) * C2;
        f.b[ni][0] = ld32(wr);
        f.b[ni][1] = ld32(wr + 16);
      }
    });
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
          const char2 xv = *reinterpret_cast<const char2*>(x + off + n);
          const float v0 = leaky(affine(acc[mi][ni][hh * 2 + 0], a2[n], b2[n]));
          const float v1 = leaky(affine(acc[mi][ni][hh * 2 + 1], a2[n + 1], b2[n + 1]));
          char2 out;
          out.x = requant(__fadd_rn(v0, __fmul_rn((float)xv.x, sx)), inv_sout);
          out.y = requant(__fadd_rn(v1, __fmul_rn((float)xv.y, sx)), inv_sout);
          *reinterpret_cast<char2*>(y + off + n) = out;
        }
      }
  }
}

}  // namespace

extern "C" int amyolo_int8_block_smem_bytes(int W, int C2, int strip) {
  return (strip + 2) * (W + 2) * (C2 + kPad);
}

extern "C" int amyolo_fused_residual_block_int8(
    const void* x, const void* w1t, const void* a1, const void* b1, const void* w2t,
    const void* a2, const void* b2, void* y, int B, int H, int W, int C, int C2,
    int strip, int oc_tile, float sx, float inv_s1, float inv_sout, void* stream) {
  const int smem = amyolo_int8_block_smem_bytes(W, C2, strip);
  cudaError_t err = cudaFuncSetAttribute(
      fused_residual_block_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((H + strip - 1) / strip) * (C / oc_tile)), (unsigned)B);
  fused_residual_block_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w1t, (const float*)a1, (const float*)b1,
      (const int8_t*)w2t, (const float*)a2, (const float*)b2, (int8_t*)y, H, W, C, C2,
      strip, oc_tile, sx, inv_s1, inv_sout);
  return (int)cudaGetLastError();
}
