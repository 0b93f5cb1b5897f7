// K3: one quantized Darknet residual unit in one launch, int8 NHWC in and out.
//
//   h = q(leaky(float(conv1x1(x)) * a1 + b1), inv_s1)   zero outside the image
//   y = q(leaky(float(conv3x3(h)) * a2 + b2) + float(x) * sx, inv_sout)
//   q(v, inv) = clamp(round_half_even(v * inv), -127, 127)
//
// Replaces the reference package's Pallas kernel
// pallas/int8_block.py:fused_residual_block_int8 (the pl.pallas_call at
// :150, body _block_kernel at :60).  The TPU kernel's grid walks (image, row
// strip) and fetches the one-row halos as extra BlockSpecs.  Here the design
// is K2's (conv_block.cu) in int8: each block owns one tile, (image, strip of
// output rows, range of output columns, range of output channels), chosen by
// kernels/conv_block.py:plan_launch for kernels/int8_block.py:K3.
//
//   1. The 1x1 for the tile's pixels plus a one-pixel halo goes into shared
//      memory as int8, requantized at s1.  Only halo pixels inside the image
//      are computed and stored; one extra zero pixel stands for every hidden
//      pixel outside the image (the hidden map is zero there, not
//      1x1(0) = q(leaky(b1))), so the 3x3 taps that fall outside read it.
//   2. The 3x3 reads its A operand straight from that hidden tile (nine
//      shifted row addresses per pixel); the epilogue adds the shortcut x*sx
//      and requantizes at s_out.
//
// Both convs are implicit GEMMs on the tensor cores through
// mma.sync.m16n8k32 (s8 x s8 -> s32, exact).  Eight warps each own a
// 64-pixel tile 32 or 64 channels wide (8*NT) of a block tile BM x BN.  K
// advances in slices through a ring of shared-memory stages fed by
// cp.async.cg (16-byte copies by all 256 threads, one __syncthreads per
// slice): each weight slice is copied once per block and read by every
// warp, and in the 1x1 the x pixels go through the same ring (zero-filled
// past the tile's last pixel).  The 1x1 ring holds 3 stages of A + B in
// 64-channel slices (4 with 64-channel warps); the 3x3 reuses its bytes for
// 3 to 8 stages of B alone, in slices of 128 channels (C/2 where that is
// less).  Ring rows carry 16 bytes of padding and hidden pixels C/2 + 16
// bytes, so the ldmatrix.x4 loads of both operands are free of bank
// conflicts: in bytes, the s8 fragments of m16n8k32 are the bf16 fragments
// of m16n8k16 (mma_ring.cuh), and K is contiguous in x, in the hidden map
// and in w1t/w2t.  m16 tiles past the tile's pixels and warps whose
// channels lie past the 1x1's C/2 issue no MMA.  Where shared memory leaves
// room for two blocks an SM, the kernel is built for two (128 registers a
// thread); otherwise for one, which double-buffers its fragments or takes
// the 64-channel warp tile.
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
// are operation-bound).  The halo's 1x1 is computed once per tile, and once
// per output-channel tile: the plan keeps the executed work within 0.05 of
// the row-strip tiling of K3's first version, which executed 1.03, 1.03,
// 1.26, 1.59 and 2.58 times the unit's work at the five stages
// (kernels/conv_block.py:strip_work_ratio).  As in K2, mma.sync with
// ldmatrix fragments leaves the warps' instruction stream, not the tensor
// cores, as the limit; wgmma is the next step (ROADMAP.md).
#include "mma_ring.cuh"

namespace {

using namespace mma_ring;

constexpr int kSlice1 = 64;              // int8 channels (bytes) per 1x1 ring stage
constexpr int kRow1 = kSlice1 + 16;      // its ring row (80 bytes)
constexpr int kPad = 16;                 // bytes of padding per hidden pixel
constexpr float kSlope = 0.1f;           // LeakyReLU slope, f32(0.1)

// Block tile BM x BN of warps 8*NT channels wide, and a ring of S1 1x1
// stages (A + B)
template <int BN, int S1, int NT>
struct Tile {
  static constexpr int kWN = BN / (8 * NT);
  static constexpr int kWM = kWarps / kWN;
  static constexpr int kBM = kWM * kWarpM;
  static constexpr int kRing = S1 * (kBM + BN) * kRow1;  // bytes
  static_assert(kWN * kWM == kWarps, "tile");
};

// 3x3 ring: slices of KS channels in rows of KS + 16 bytes, as many stages
// as the ring holds (at most 8)
template <int BN, int S1, int KS, int NT>
struct Ring2 {
  static constexpr int kRow = KS + 16;
  static constexpr int n = Tile<BN, S1, NT>::kRing / (BN * kRow);
  static constexpr int kStages = n < 8 ? n : 8;
  static_assert(kStages >= 3, "ring");
};

int ring_bytes(int bn, int warp_n) {
  const int bm = kWarps * kWarpM * warp_n / bn;
  return ring_stages(warp_n) * (bm + bn) * kRow1;
}

struct Args {
  const int8_t* x;
  const int8_t* w1t;
  const float* a1;
  const float* b1;
  const int8_t* w2t;
  const float* a2;
  const float* b2;
  int8_t* y;
  int H, W, C, C2, strip, col_tile, oc_tile, n_strips, n_cols, n_oc;
  float sx, inv_s1, inv_sout;
};

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : __fmul_rn(v, kSlope);
}

// v * a + b with the multiply and the add each rounded
__device__ __forceinline__ float affine(int acc, float a, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

__device__ __forceinline__ int8_t requant(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return (int8_t)max(-127, min(127, q));
}

// d += a * b for one m16n8k32 tile (PTX ISA fragment layouts for .s8:
// a = {A[g][4t..], A[g+8][4t..], A[g][4t+16..], A[g+8][4t+16..]},
// b = {B[4t..][g], B[4t+16..][g]}, d = {D[g][2t..], D[g+8][2t..]}).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
using Acc = int[kMT][NT][4];

template <int NT>
__device__ __forceinline__ void zero(Acc<NT>& acc) {
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

// The A and B fragments of 32-deep step kk of a slice (see mma_slice).
template <int B_ROW, int NT>
__device__ __forceinline__ void load_frags(uint32_t (&af)[kMT][4], uint32_t (&bf)[NT][2],
                                           const uint32_t (&a)[kMT], int mt, uint32_t b,
                                           int kk) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t r[4];
    ldmatrix_x4(r, b + j * 16 * B_ROW + kk * 32);
    bf[2 * j][0] = r[0];
    bf[2 * j][1] = r[1];
    bf[2 * j + 1][0] = r[2];
    bf[2 * j + 1][1] = r[3];
  }
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
    if (mi < mt) ldmatrix_x4(af[mi], a[mi] + kk * 32);
}

template <int NT>
__device__ __forceinline__ void mma_frags(Acc<NT>& acc, const uint32_t (&af)[kMT][4],
                                          const uint32_t (&bf)[NT][2], int mt) {
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
    if (mi < mt) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
}

// acc += A (the warp's 64 rows) x B (its 8*NT columns) over one KS-deep
// slice (KS bytes).  a[mi]: shared address of this lane's ldmatrix row of
// m16 tile mi (row lane % 16, byte offset 16 * (lane / 16)); b: of this
// lane's row of the first 16 columns (column 8 * (lane / 16) + lane % 8,
// byte offset 16 * (lane / 8 % 2)) in rows of B_ROW bytes.  Only m16 tiles
// < mt run.  With DB the fragments of the next 32-deep step load while the
// MMAs of this one issue.
template <int KS, int B_ROW, bool DB, int NT>
__device__ __forceinline__ void mma_slice(Acc<NT>& acc, const uint32_t (&a)[kMT], int mt,
                                          uint32_t b) {
  if constexpr (DB) {
    uint32_t af[2][kMT][4], bf[2][NT][2];
    load_frags<B_ROW, NT>(af[0], bf[0], a, mt, b, 0);
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk) {
      if (kk + 1 < KS / 32)
        load_frags<B_ROW, NT>(af[(kk + 1) & 1], bf[(kk + 1) & 1], a, mt, b, kk + 1);
      mma_frags<NT>(acc, af[kk & 1], bf[kk & 1], mt);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk) {
      uint32_t af[kMT][4], bf[NT][2];
      load_frags<B_ROW, NT>(af, bf, a, mt, b, kk);
      mma_frags<NT>(acc, af, bf, mt);
    }
  }
}

template <int BN, int KS2, int MINB, int S1, int NT>
__global__ void __launch_bounds__(kThreads, MINB)
    fused_residual_block_int8_kernel(const Args p) {
  constexpr int kWarpN = 8 * NT;
  constexpr bool DB = MINB == 1 && NT == 4;  // registers to spare: double-buffer fragments
  using T = Tile<BN, S1, NT>;
  constexpr int BM = T::kBM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* hid = reinterpret_cast<int8_t*>(smem_raw);
  const int cs = p.C2 + kPad;  // hidden pixel stride, bytes
  int8_t* ring = hid + (min(p.strip + 2, p.H) * min(p.col_tile + 2, p.W) + 1) * cs;

  int t = blockIdx.x;
  const int oc0 = (t % p.n_oc) * p.oc_tile;
  t /= p.n_oc;
  const int c0 = (t % p.n_cols) * p.col_tile;
  t /= p.n_cols;
  const int r0 = (t % p.n_strips) * p.strip;
  const long long img = t / p.n_strips;
  const int rows = min(p.strip, p.H - r0), cols = min(p.col_tile, p.W - c0);
  // hidden tile: image pixels [hr0, hr0 + nhr) x [hc0, hc0 + nhc), row-major;
  // pixel m1 is the zero pixel
  const int hr0 = max(r0 - 1, 0), hc0 = max(c0 - 1, 0);
  const int nhr = min(r0 + rows, p.H - 1) - hr0 + 1;
  const int nhc = min(c0 + cols, p.W - 1) - hc0 + 1;
  const int m1 = nhr * nhc, m2 = rows * cols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / T::kWN, wn = warp % T::kWN;
  const int g = lane >> 2, tq = lane & 3;
  const int8_t* xb = p.x + img * p.H * p.W * p.C;
  // this lane's ldmatrix row of the B tile, without the row stride
  const int b_n = wn * kWarpN + (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 16;

  for (int i = threadIdx.x; i < cs / 16; i += kThreads)
    reinterpret_cast<uint4*>(hid + m1 * cs)[i] = make_uint4(0u, 0u, 0u, 0u);

  Acc<NT> acc;

  // ---- phase 1: hidden = q(leaky(x @ w1 * a1 + b1), s1) over the hidden tile
  {
    constexpr int kSlot = (BM + BN) * kRow1;
    constexpr int kA = BM * 4 / kThreads, kB = BN * 4 / kThreads;  // copies a thread
    const int kpt = p.C / kSlice1;
    const int ncn = (p.C2 + BN - 1) / BN;
    const int steps = (m1 + BM - 1) / BM * ncn * kpt;
    Cursor lc, cc;
    int a_mc = -1;
    const int8_t* asrc[kA];
    bool aok[kA];
    auto load = [&](int slot) {
      if (lc.mc != a_mc) {  // the x pixels of a new m chunk
        a_mc = lc.mc;
#pragma unroll
        for (int j = 0; j < kA; ++j) {
          const int i = threadIdx.x + j * kThreads;
          const int pix = a_mc * BM + (i >> 2);
          aok[j] = pix < m1;
          const int hr = aok[j] ? pix / nhc : 0, hc = aok[j] ? pix - hr * nhc : 0;
          asrc[j] = xb + ((long long)(hr0 + hr) * p.W + hc0 + hc) * p.C + (i & 3) * 16;
        }
      }
      const int k0 = lc.k * kSlice1;
      int8_t* sa = ring + slot * kSlot;
#pragma unroll
      for (int j = 0; j < kA; ++j) {
        const int i = threadIdx.x + j * kThreads;
        cp_async16(smem_u32(sa + (i >> 2) * kRow1 + (i & 3) * 16), asrc[j] + k0, aok[j]);
      }
      int8_t* sb = sa + BM * kRow1;
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int n = lc.nc * BN + (i >> 2);
        const bool ok = n < p.C2;
        cp_async16(smem_u32(sb + (i >> 2) * kRow1 + (i & 3) * 16),
                   p.w1t + (long long)(ok ? n : 0) * p.C + k0 + (i & 3) * 16, ok);
      }
      lc.next(kpt, 1, ncn);
    };
    auto compute = [&](int slot) {
      const int mbase = cc.mc * BM + wm * kWarpM, nbase = cc.nc * BN + wn * kWarpN;
      const int mt = nbase < p.C2 ? m16_tiles(m1, mbase) : 0;
      if (cc.k == 0) zero(acc);
      if (mt > 0) {
        const int8_t* sa = ring + slot * kSlot;
        uint32_t a[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
          a[mi] = smem_u32(sa + (wm * kWarpM + mi * 16 + (lane & 15)) * kRow1 + (lane >> 4) * 16);
        mma_slice<kSlice1, kRow1, DB, NT>(acc, a, mt, smem_u32(sa + (BM + b_n) * kRow1 + b_k));
        if (cc.k == kpt - 1) {
          float2 scale[NT], bias[NT];
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            scale[ni] = *reinterpret_cast<const float2*>(p.a1 + nbase + ni * 8 + 2 * tq);
            bias[ni] = *reinterpret_cast<const float2*>(p.b1 + nbase + ni * 8 + 2 * tq);
          }
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int pix = mbase + mi * 16 + hh * 8 + g;
              if (pix >= m1) continue;
#pragma unroll
              for (int ni = 0; ni < NT; ++ni) {
                char2 hv;
                hv.x = requant(leaky(affine(acc[mi][ni][hh * 2 + 0], scale[ni].x, bias[ni].x)),
                               p.inv_s1);
                hv.y = requant(leaky(affine(acc[mi][ni][hh * 2 + 1], scale[ni].y, bias[ni].y)),
                               p.inv_s1);
                *reinterpret_cast<char2*>(hid + pix * cs + nbase + ni * 8 + 2 * tq) = hv;
              }
            }
        }
      }
      cc.next(kpt, 1, ncn);
    };
    pipeline<S1>(steps, load, compute);
  }

  // ---- phase 2: y = q(leaky(conv3x3(hidden) * a2 + b2) + x * sx, s_out) over the tile
  {
    using R = Ring2<BN, S1, KS2, NT>;
    constexpr int kRow = R::kRow, kSlot = BN * kRow;
    constexpr int kChunks = BN * (KS2 / 16);  // 16-byte copies of a slice
    constexpr int kB = (kChunks + kThreads - 1) / kThreads;
    const int kpt = p.C2 / KS2;  // k-slices per tap
    const int ncn = p.oc_tile / BN;
    const int steps = (m2 + BM - 1) / BM * ncn * 9 * kpt;
    Cursor lc, cc;
    auto load = [&](int slot) {
      const int8_t* src = p.w2t + ((long long)lc.tap * p.C + oc0 + lc.nc * BN) * p.C2 + lc.k * KS2;
      int8_t* sb = ring + slot * kSlot;
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (kChunks % kThreads == 0 || i < kChunks) {
          const int row = i / (KS2 / 16), q = i % (KS2 / 16);
          cp_async16(smem_u32(sb + row * kRow + q * 16), src + (long long)row * p.C2 + q * 16,
                     true);
        }
      }
      lc.next(kpt, 9, ncn);
    };
    int prow[kMT], pcol[kMT];  // image pixel of this lane's A row, per m16 tile
    uint32_t a[kMT];
    auto compute = [&](int slot) {
      const int mbase = cc.mc * BM + wm * kWarpM, nbase = oc0 + cc.nc * BN + wn * kWarpN;
      const int mt = m16_tiles(m2, mbase);
      if (cc.k == 0 && cc.tap == 0) {
        zero(acc);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const int q = mbase + mi * 16 + (lane & 15);
          const int r = q / cols;
          prow[mi] = q < m2 ? r0 + r : -8;  // -8: every tap reads the zero pixel
          pcol[mi] = c0 + q - r * cols;
        }
      }
      if (mt > 0) {
        if (cc.k == 0) {
          const int di = cc.tap / 3 - 1, dj = cc.tap % 3 - 1;
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            const int hr = prow[mi] + di, hc = pcol[mi] + dj;
            const bool in = hr >= 0 && hr < p.H && hc >= 0 && hc < p.W;
            const int idx = in ? (hr - hr0) * nhc + hc - hc0 : m1;
            a[mi] = smem_u32(hid + idx * cs + (lane >> 4) * 16);
          }
        }
        uint32_t ak[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) ak[mi] = a[mi] + cc.k * KS2;
        mma_slice<KS2, kRow, DB, NT>(acc, ak, mt, smem_u32(ring + slot * kSlot + b_n * kRow + b_k));
        if (cc.k == kpt - 1 && cc.tap == 8) {
          // per m16 tile, every load of the shortcut first, then the stores
          // (y may alias x as far as the compiler knows)
          float2 scale[NT], bias[NT];
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            scale[ni] = *reinterpret_cast<const float2*>(p.a2 + nbase + ni * 8 + 2 * tq);
            bias[ni] = *reinterpret_cast<const float2*>(p.b2 + nbase + ni * 8 + 2 * tq);
          }
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            if (mi >= mt) continue;
            long long off[2];
            char2 xv[2][NT];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int q = mbase + mi * 16 + hh * 8 + g;
              const int r = q / cols;
              off[hh] = q < m2 ? ((img * p.H + r0 + r) * p.W + c0 + q - r * cols) * (long long)p.C
                                   + nbase + 2 * tq
                               : -1;
#pragma unroll
              for (int ni = 0; ni < NT; ++ni)
                if (off[hh] >= 0)
                  xv[hh][ni] = *reinterpret_cast<const char2*>(p.x + off[hh] + ni * 8);
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              if (off[hh] < 0) continue;
#pragma unroll
              for (int ni = 0; ni < NT; ++ni) {
                const float v0 = leaky(affine(acc[mi][ni][hh * 2 + 0], scale[ni].x, bias[ni].x));
                const float v1 = leaky(affine(acc[mi][ni][hh * 2 + 1], scale[ni].y, bias[ni].y));
                char2 out;
                out.x = requant(__fadd_rn(v0, __fmul_rn((float)xv[hh][ni].x, p.sx)), p.inv_sout);
                out.y = requant(__fadd_rn(v1, __fmul_rn((float)xv[hh][ni].y, p.sx)), p.inv_sout);
                *reinterpret_cast<char2*>(p.y + off[hh] + ni * 8) = out;
              }
            }
          }
        }
      }
      cc.next(kpt, 9, ncn);
    };
    pipeline<R::kStages>(steps, load, compute);
  }
}

template <int BN, int KS2, int MINB, int S1, int NT>
cudaError_t prepare() {  // raise the shared-memory limit, once per device
  return once_per_device([] {
    auto* kernel = fused_residual_block_int8_kernel<BN, KS2, MINB, S1, NT>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  });
}

// Launch (blocks > 0) or report the resident blocks per SM (blocks == 0,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, or minus the CUDA error).
template <int BN, int KS2, int MINB, int S1, int NT>
int run(const Args& a, int blocks, int smem, cudaStream_t stream) {
  auto* kernel = fused_residual_block_int8_kernel<BN, KS2, MINB, S1, NT>;
  cudaError_t err = prepare<BN, KS2, MINB, S1, NT>();
  if (err != cudaSuccess) return blocks ? (int)err : -(int)err;
  if (blocks == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
    return err == cudaSuccess ? n : -(int)err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// 32-channel warps: two blocks an SM (128 registers) where shared memory
// leaves room for them, else one that double-buffers its fragments.
template <int BN, int KS2>
int run32(const Args& a, int blocks, int smem, cudaStream_t stream) {
  constexpr int S1 = ring_stages(32);
  return kSmPerSm / (smem + kSmemReserved) >= 2 ? run<BN, KS2, 2, S1, 4>(a, blocks, smem, stream)
                                                : run<BN, KS2, 1, S1, 4>(a, blocks, smem, stream);
}

// The kernel for (warp_n, bn, C/2, smem).  The 3x3 slice is 128 channels,
// or C/2 where that is 64 or 32 (kernels/int8_block.py:K3).  64-channel
// warps (C/2 a multiple of 64, bn 128 or 256) run one block an SM;
// 32-channel warps take bn 64 or 128.
int dispatch(const Args& a, int warp_n, int bn, int blocks, int smem, cudaStream_t stream) {
  constexpr int S64 = ring_stages(64);
  const int ks = a.C2 % 128 == 0 ? 128 : a.C2 % 64 == 0 ? 64 : 32;
  if (warp_n == 64 && ks >= 64) {
    if (bn == 128)
      return ks == 128 ? run<128, 128, 1, S64, 8>(a, blocks, smem, stream)
                       : run<128, 64, 1, S64, 8>(a, blocks, smem, stream);
    if (bn == 256)
      return ks == 128 ? run<256, 128, 1, S64, 8>(a, blocks, smem, stream)
                       : run<256, 64, 1, S64, 8>(a, blocks, smem, stream);
  }
  if (warp_n == 32) {
    if (bn == 64)
      return ks == 128  ? run32<64, 128>(a, blocks, smem, stream)
             : ks == 64 ? run32<64, 64>(a, blocks, smem, stream)
                        : run32<64, 32>(a, blocks, smem, stream);
    if (bn == 128)
      return ks == 128  ? run32<128, 128>(a, blocks, smem, stream)
             : ks == 64 ? run32<128, 64>(a, blocks, smem, stream)
                        : run32<128, 32>(a, blocks, smem, stream);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory of one block: the tile's hidden pixels (halo included,
// image pixels only) plus the zero pixel, then the ring.  The same formula
// as kernels/conv_block.py:smem_bytes for kernels/int8_block.py:K3.
extern "C" int amyolo_int8_block_smem_bytes(int H, int W, int C2, int strip, int col_tile,
                                            int warp_n, int bn) {
  const int hidden = (strip + 2 < H ? strip + 2 : H) * (col_tile + 2 < W ? col_tile + 2 : W) + 1;
  return hidden * (C2 + kPad) + ring_bytes(bn, warp_n);
}

// Resident blocks per SM of the kernel for (warp_n, bn, C/2) at `smem`
// bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA
// error.
extern "C" int amyolo_int8_block_blocks_per_sm(int warp_n, int bn, int C2, int smem) {
  Args a{};
  a.C2 = C2;
  return dispatch(a, warp_n, bn, 0, smem, nullptr);
}

// x, y: (B, H, W, C) int8.  w1t: (C2, C) int8 (out-channel major, input
// channel contiguous).  w2t: (9, C, C2) int8, tap = 3*di + dj.  a1, b1:
// (C2,) f32.  a2, b2: (C,) f32.  C % 64 == 0, C2 = C / 2; every pointer
// 16-byte aligned.  One block per tile of strip rows x col_tile columns x
// oc_tile channels; warp_n (32 or 64) channels a warp, bn the block tile
// width; smem must equal amyolo_int8_block_smem_bytes.
extern "C" int amyolo_fused_residual_block_int8(
    const void* x, const void* w1t, const void* a1, const void* b1, const void* w2t,
    const void* a2, const void* b2, void* y, int B, int H, int W, int C, int C2, int strip,
    int col_tile, int oc_tile, int warp_n, int bn, int smem, float sx, float inv_s1,
    float inv_sout, void* stream) {
  if (B <= 0 || C % 64 || C2 * 2 != C || oc_tile <= 0 || C % oc_tile || oc_tile % bn ||
      strip <= 0 || col_tile <= 0 || smem > kMaxSmem ||
      smem != amyolo_int8_block_smem_bytes(H, W, C2, strip, col_tile, warp_n, bn))
    return (int)cudaErrorInvalidValue;
  Args a{(const int8_t*)x, (const int8_t*)w1t, (const float*)a1, (const float*)b1,
         (const int8_t*)w2t, (const float*)a2, (const float*)b2, (int8_t*)y,
         H, W, C, C2, strip, col_tile, oc_tile,
         (H + strip - 1) / strip, (W + col_tile - 1) / col_tile, C / oc_tile,
         sx, inv_s1, inv_sout};
  const int blocks = B * a.n_strips * a.n_cols * a.n_oc;
  const int err = dispatch(a, warp_n, bn, blocks, smem, (cudaStream_t)stream);
  return err < 0 ? -err : err;
}
