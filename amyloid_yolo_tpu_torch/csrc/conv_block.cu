// K2: one BN-folded Darknet residual unit in one launch, bf16 NHWC.
//
//   h = bf16(leaky(conv1x1(x) + b1))          f32 accumulate, f32 bias
//   y = bf16(float(x) + leaky(conv3x3(h) + b2))   zero-padded h, f32 add
//
// Replaces the reference package's Pallas kernel
// pallas/conv_block.py:fused_residual_block (the pl.pallas_call at :107,
// body _block_kernel at :50).  The TPU kernel holds a whole image in VMEM;
// a Hopper block has at most 227 KB of shared memory, so here each block
// owns one tile: (image, strip of output rows, range of output columns,
// range of output channels), chosen by kernels/conv_block.py:plan_launch.
//
//   1. The 1x1 for the tile's pixels plus a one-pixel halo goes into shared
//      memory as bf16, after the f32 bias and leaky.  Only halo pixels inside
//      the image are computed and stored; one extra zero pixel stands for
//      every hidden pixel outside the image (the hidden map is zero there,
//      not 1x1(0) = leaky(b1)), so the 3x3 taps that fall outside read it.
//   2. The 3x3 reads its A operand straight from that hidden tile (nine
//      shifted row addresses per pixel), then the f32 epilogue adds b2,
//      applies leaky, adds the residual x in f32 and rounds to bf16.
//
// Both convs are implicit GEMMs on the tensor cores, bf16 in, f32
// accumulate, with K advancing in slices through a ring of shared-memory
// stages fed by cp.async.cg (16-byte copies by all 256 threads,
// commit_group / wait_group, one __syncthreads per slice): each weight
// slice is copied once per block and read by every warp.  The ring sits at
// offset 0 of dynamic shared memory (1024-byte aligned), the hidden tile
// after it.  A block is 8 warps over a block tile BM x BN (kernels/
// conv_block.py:Plan); which warp owns what differs by phase.
//
//   The 1x1 (phase 1) runs mma.sync.m16n8k16 fed by ldmatrix: each warp
//   owns a 64-pixel tile 32 or 64 channels wide (8*NT), and the x pixels go
//   through the ring beside the weights (3 stages of A + B in 32-channel
//   slices, 4 with 64-channel warps; rows of 40 bf16, 8 of them padding, so
//   ldmatrix is free of bank conflicts; zero-filled past the tile's last
//   pixel).  m16 tiles past the tile's pixels and warps whose channels lie
//   past C/2 issue no MMA.
//
//   The 3x3 (phase 2) of every unit whose C/2 is a multiple of 64 (22 of
//   YOLOv3-416's 23 units) runs wgmma.mma_async (sm_90a).  The two
//   warpgroups each own half the block tile's rows and all BN channels, as
//   BM/128 products m64nBNk16 per 16-deep step; warp w of a warpgroup holds
//   rows 16*(w%4)..+15 of each m64 block, as many f32 accumulators a thread
//   as the 1x1's warp tile.  A comes from registers: one ldmatrix.x4 from
//   the hidden tile per m64 block and step, through the nine shifted row
//   addresses (rows past the tile's pixels read the zero pixel, compute
//   throw-away rows and are stored nowhere; every m64 block issues, even
//   one wholly past them).  B comes from the ring through a descriptor:
//   64-channel slices of BN rows of 128 bytes, K-major, in the 128-byte
//   swizzle (16-byte chunk q of row n at chunk q ^ (n % 8)), 3 to 8
//   stages; each 16-deep step advances the descriptor 32 bytes inside the
//   swizzle atom.  Per slice: wgmma.fence, the wgmmas, commit_group and
//   wait_group 0 before the ring's barrier (each thread fences its landed
//   copies to the async proxy first).  The 208^2 x 64 unit (C/2 = 32,
//   32-channel slices) keeps the mma.sync 3x3 of the 1x1's warp tiles,
//   with rows padded by 8 bf16.  Which 3x3 runs is fixed by C/2 alone
//   (dispatch); nothing falls back at run time.
//
// Where shared memory leaves room for two blocks an SM, the kernel is built
// for two (128 registers a thread); otherwise for one, which
// double-buffers the mma.sync fragments across 16-deep steps or takes the
// 64-channel warp tile (fewer ldmatrix per MMA).
//
// Bound on an H100: compute for the units of 128 channels and more
// (20*H*W*C*C/2 FLOPs per image, 1.77 GFLOP at every stage of YOLOv3-416:
// ~1.8 us at 989 TFLOP/s); the 208^2 x 64 unit is memory-bound (4*H*W*C
// bytes per image, ~3.3 us).  On the mma.sync version of the 3x3 the MMAs
// were not the limit: a build without them took most of the time of a
// launch (the warps' instruction stream of ldmatrix, addressing, barriers
// and copies; PERF.md).  wgmma takes the B fragments and most MMA issue off
// that stream: per 64-deep slice a warp issues 4 ldmatrix.x4 per m64 block
// and its warpgroup 4 wgmma per block.  Still to come (ROADMAP.md): a
// wgmma group in flight across slices, TMA with mbarriers and a producer
// warp, wgmma in the 1x1, and a thread-block cluster that shares the 1x1 of
// the 512- and 1024-channel units through distributed shared memory.
#include <cuda_bf16.h>

#include "mma_ring.cuh"

namespace {

using namespace mma_ring;

constexpr int kSlice1 = 32;              // k per 1x1 ring stage
constexpr int kRow1 = kSlice1 + 8;       // its ring row (80 bytes)
constexpr int kPad = 8;                  // bf16 of padding per hidden pixel
constexpr float kSlope = 0.1f;           // LeakyReLU slope

// Block tile BM x BN of warps 8*NT channels wide, and a ring of S1 1x1
// stages (A + B)
template <int BN, int S1, int NT>
struct Tile {
  static constexpr int kWN = BN / (8 * NT);
  static constexpr int kWM = kWarps / kWN;
  static constexpr int kBM = kWM * kWarpM;
  static constexpr int kRing = S1 * (kBM + BN) * kRow1;  // bf16
  static_assert(kWN * kWM == kWarps, "tile");
};

// 3x3 ring: slices of KS channels, as many stages as the ring holds (at
// most 8).  64-channel slices feed wgmma: rows of 128 bytes, unpadded, in
// the 128-byte swizzle; 32-channel slices feed ldmatrix, in rows of KS + 8.
template <int BN, int S1, int KS, int NT>
struct Ring2 {
  static constexpr int kRow = KS == 64 ? KS : KS + 8;
  static constexpr int n = Tile<BN, S1, NT>::kRing / (BN * kRow);
  static constexpr int kStages = n < 8 ? n : 8;
  static_assert(kStages >= 3, "ring");
};

int ring_bytes(int bn, int warp_n) {
  const int bm = kWarps * kWarpM * warp_n / bn;
  return 2 * ring_stages(warp_n) * (bm + bn) * kRow1;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w1t;
  const float* b1;
  const __nv_bfloat16* w2t;
  const float* b2;
  __nv_bfloat16* y;
  int H, W, C, C2, strip, col_tile, oc_tile, n_strips, n_cols, n_oc;
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * kSlope; }

// d += a * b for one m16n8k16 tile (PTX ISA fragment layouts).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- wgmma (sm_90a), for the 3x3

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), the atom 1024-byte
// aligned; LBO is unused for this layout (1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (no instruction).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define D16(i) D4(i), D4((i) + 4), D4((i) + 8), D4((i) + 12)
#define D32(i) D16(i), D16((i) + 16)
#define D64(i) D32(i), D32((i) + 32)
#define D128(i) D64(i), D64((i) + 64)

// d += A (64 x 16, this warp's 16 rows in a: the m16n8k16 A fragment) x B
// (16 x N from the descriptor b, K-major), f32 accumulate.  d[4j + e] is
// element e of n8 tile j in mma.sync's accumulator layout: row g (e < 2) or
// g + 8 of the warp's 16, column 8j + 2*(lane % 4) + e % 2.
template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : D64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : D128(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef D4
#undef D16
#undef D32
#undef D64
#undef D128

template <int NT>
using Acc = float[kMT][NT][4];

template <int NT>
__device__ __forceinline__ void zero(Acc<NT>& acc) {
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// The A and B fragments of 16-deep step kk of a slice (see mma_slice).
template <int KS, int B_ROW, int NT>
__device__ __forceinline__ void load_frags(uint32_t (&af)[kMT][4], uint32_t (&bf)[NT][2],
                                           const uint32_t (&a)[kMT], int mt, uint32_t b,
                                           int kk) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t r[4];
    ldmatrix_x4(r, b + (j * 16 * B_ROW + kk * 16) * 2);
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
      for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
}

// acc += A (the warp's 64 rows) x B (its 8*NT columns) over one KS-deep
// slice.  a[mi]: shared address of this lane's ldmatrix row of m16 tile mi
// (row lane % 16, k offset 8 * (lane / 16)); b: of this lane's row of the
// first 16 columns (column 8 * (lane / 16) + lane % 8, k offset
// 8 * (lane / 8 % 2)) in rows of B_ROW bf16.  Only m16 tiles < mt run.  With
// DB the fragments of the next 16-deep step load while the MMAs of this one
// issue (24 more registers).
template <int KS, int B_ROW, bool DB, int NT>
__device__ __forceinline__ void mma_slice(Acc<NT>& acc, const uint32_t (&a)[kMT], int mt,
                                          uint32_t b) {
  if constexpr (DB) {
    uint32_t af[2][kMT][4], bf[2][NT][2];
    load_frags<KS, B_ROW, NT>(af[0], bf[0], a, mt, b, 0);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      if (kk + 1 < KS / 16)
        load_frags<KS, B_ROW, NT>(af[(kk + 1) & 1], bf[(kk + 1) & 1], a, mt, b, kk + 1);
      mma_frags<NT>(acc, af[kk & 1], bf[kk & 1], mt);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t af[kMT][4], bf[NT][2];
      load_frags<KS, B_ROW, NT>(af, bf, a, mt, b, kk);
      mma_frags<NT>(acc, af, bf, mt);
    }
  }
}

template <int BN, int KS2, int MINB, int S1, int NT>
__global__ void __launch_bounds__(kThreads, MINB) fused_residual_block_kernel(const Args p) {
  constexpr int kWarpN = 8 * NT;
  constexpr bool DB = MINB == 1 && NT == 4;  // registers to spare: double-buffer fragments
  using T = Tile<BN, S1, NT>;
  constexpr int BM = T::kBM;
  // the ring at offset 0 (its 3x3 slots 1024-byte aligned for the swizzle),
  // then the hidden tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hid = ring + T::kRing;
  const int cs = p.C2 + kPad;  // hidden pixel stride

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
  const __nv_bfloat16* xb = p.x + img * p.H * p.W * p.C;
  // this lane's ldmatrix row of the B tile, without the row stride
  const int b_n = wn * kWarpN + (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 8;

  for (int i = threadIdx.x; i < cs / 8; i += kThreads)
    reinterpret_cast<uint4*>(hid + m1 * cs)[i] = make_uint4(0u, 0u, 0u, 0u);

  Acc<NT> acc;

  // ---- phase 1: hidden = leaky(x @ w1 + b1) over the hidden tile
  {
    constexpr int kSlot = (BM + BN) * kRow1;
    constexpr int kA = BM * 4 / kThreads, kB = BN * 4 / kThreads;  // copies a thread
    const int kpt = p.C / kSlice1;
    const int ncn = (p.C2 + BN - 1) / BN;
    const int steps = (m1 + BM - 1) / BM * ncn * kpt;
    Cursor lc, cc;
    int a_mc = -1;
    const __nv_bfloat16* asrc[kA];
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
          asrc[j] = xb + ((long long)(hr0 + hr) * p.W + hc0 + hc) * p.C + (i & 3) * 8;
        }
      }
      const int k0 = lc.k * kSlice1;
      __nv_bfloat16* sa = ring + slot * kSlot;
#pragma unroll
      for (int j = 0; j < kA; ++j) {
        const int i = threadIdx.x + j * kThreads;
        cp_async16(smem_u32(sa + (i >> 2) * kRow1 + (i & 3) * 8), asrc[j] + k0, aok[j]);
      }
      __nv_bfloat16* sb = sa + BM * kRow1;
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int n = lc.nc * BN + (i >> 2);
        const bool ok = n < p.C2;
        cp_async16(smem_u32(sb + (i >> 2) * kRow1 + (i & 3) * 8),
                   p.w1t + (long long)(ok ? n : 0) * p.C + k0 + (i & 3) * 8, ok);
      }
      lc.next(kpt, 1, ncn);
    };
    auto compute = [&](int slot) {
      const int mbase = cc.mc * BM + wm * kWarpM, nbase = cc.nc * BN + wn * kWarpN;
      const int mt = nbase < p.C2 ? m16_tiles(m1, mbase) : 0;
      if (cc.k == 0) zero(acc);
      if (mt > 0) {
        const __nv_bfloat16* sa = ring + slot * kSlot;
        uint32_t a[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
          a[mi] = smem_u32(sa + (wm * kWarpM + mi * 16 + (lane & 15)) * kRow1 + (lane >> 4) * 8);
        mma_slice<kSlice1, kRow1, DB, NT>(acc, a, mt, smem_u32(sa + (BM + b_n) * kRow1 + b_k));
        if (cc.k == kpt - 1) {
          float2 bias[NT];
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
            bias[ni] = *reinterpret_cast<const float2*>(p.b1 + nbase + ni * 8 + 2 * tq);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int pix = mbase + mi * 16 + hh * 8 + g;
              if (pix >= m1) continue;
#pragma unroll
              for (int ni = 0; ni < NT; ++ni) {
                const int n = nbase + ni * 8 + 2 * tq;
                const float v0 = leaky(acc[mi][ni][hh * 2 + 0] + bias[ni].x);
                const float v1 = leaky(acc[mi][ni][hh * 2 + 1] + bias[ni].y);
                *reinterpret_cast<__nv_bfloat162*>(hid + pix * cs + n) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
        }
      }
      cc.next(kpt, 1, ncn);
    };
    pipeline<S1>(steps, load, compute);
  }

  // ---- phase 2: y = x + leaky(conv3x3(hidden) + b2) over the tile
  if constexpr (KS2 == 64) {  // on wgmma
    using R = Ring2<BN, S1, KS2, NT>;
    constexpr int MB = BM / 128;               // m64 blocks of a warpgroup
    constexpr int kSlot = BN * KS2, kB = BN * (KS2 / 8) / kThreads;
    constexpr int kEp = 8;                     // n8 tiles per epilogue chunk
    const int kpt = p.C2 / KS2;                // k-slices per tap
    const int ncn = p.oc_tile / BN;
    const int steps = (m2 + BM - 1) / BM * ncn * 9 * kpt;
    const int wg = warp >> 2, wr = warp & 3;   // warpgroup, warp in it
    Cursor lc, cc;
    auto load = [&](int slot) {
      const __nv_bfloat16* src =
          p.w2t + ((long long)lc.tap * p.C + oc0 + lc.nc * BN) * p.C2 + lc.k * KS2;
      __nv_bfloat16* sb = ring + slot * kSlot;
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int row = i >> 3, q = i & 7;  // 16-byte chunk q of weight row `row`
        cp_async16(smem_u32(sb + row * KS2 + ((q ^ (row & 7)) << 3)),
                   src + (long long)row * p.C2 + q * 8, true);
      }
      lc.next(kpt, 9, ncn);
    };
    float acc2[MB][BN / 2];
    int prow[MB], pcol[MB];  // image pixel of this lane's A row, per m64 block
    uint32_t a[MB];
    auto compute = [&](int slot) {
      const int mrow = cc.mc * BM + wg * (BM / 2);  // the warpgroup's first row
      const int nbase = oc0 + cc.nc * BN;
      if (cc.k == 0 && cc.tap == 0) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc2[mb][i] = 0.f;
          const int q = mrow + mb * 64 + wr * 16 + (lane & 15);
          const int r = q / cols;
          prow[mb] = q < m2 ? r0 + r : -8;  // -8: every tap reads the zero pixel
          pcol[mb] = c0 + q - r * cols;
        }
      }
      if (cc.k == 0) {
        const int di = cc.tap / 3 - 1, dj = cc.tap % 3 - 1;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const int hr = prow[mb] + di, hc = pcol[mb] + dj;
          const bool in = hr >= 0 && hr < p.H && hc >= 0 && hc < p.W;
          const int idx = in ? (hr - hr0) * nhc + hc - hc0 : m1;
          a[mb] = smem_u32(hid + idx * cs + (lane >> 4) * 8);
        }
      }
      // Every m64 block issues, those wholly past the tile's pixels too (on
      // the zero pixel, stored nowhere): ptxas serializes a wgmma under a
      // branch that it cannot prove the same for the whole warpgroup.
      uint32_t af[MB][KS2 / 16][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int kk = 0; kk < KS2 / 16; ++kk)
          ldmatrix_x4(af[mb][kk], a[mb] + (cc.k * KS2 + kk * 16) * 2);
      const uint64_t desc = sw128_desc(smem_u32(ring + slot * kSlot));
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_acc(acc2[mb]);
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int kk = 0; kk < KS2 / 16; ++kk)
          Wgmma<BN>::mma(acc2[mb], af[mb][kk], desc + 2 * kk);  // +32 bytes a step
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_acc(acc2[mb]);
      if (cc.k == kpt - 1 && cc.tap == 8) {
        // per m64 block and 64 channels, every load of the residual first,
        // then the stores (y may alias x as far as the compiler knows)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if (mrow + mb * 64 >= m2) continue;
          long long off[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = mrow + mb * 64 + wr * 16 + hh * 8 + g;
            const int r = q / cols;
            off[hh] = q < m2 ? ((img * p.H + r0 + r) * p.W + c0 + q - r * cols) * (long long)p.C
                                 + nbase + 2 * tq
                             : -1;
          }
#pragma unroll
          for (int n0 = 0; n0 < BN / 8; n0 += kEp) {
            float2 bias[kEp];
            __nv_bfloat162 xv[2][kEp];
#pragma unroll
            for (int ni = 0; ni < kEp; ++ni)
              bias[ni] = *reinterpret_cast<const float2*>(p.b2 + nbase + (n0 + ni) * 8 + 2 * tq);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int ni = 0; ni < kEp; ++ni)
                if (off[hh] >= 0)
                  xv[hh][ni] =
                      *reinterpret_cast<const __nv_bfloat162*>(p.x + off[hh] + (n0 + ni) * 8);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              if (off[hh] < 0) continue;
#pragma unroll
              for (int ni = 0; ni < kEp; ++ni) {
                const float v0 = leaky(acc2[mb][(n0 + ni) * 4 + hh * 2 + 0] + bias[ni].x);
                const float v1 = leaky(acc2[mb][(n0 + ni) * 4 + hh * 2 + 1] + bias[ni].y);
                *reinterpret_cast<__nv_bfloat162*>(p.y + off[hh] + (n0 + ni) * 8) =
                    __floats2bfloat162_rn(__bfloat162float(xv[hh][ni].x) + v0,
                                          __bfloat162float(xv[hh][ni].y) + v1);
              }
            }
          }
        }
      }
      cc.next(kpt, 9, ncn);
    };
    pipeline<R::kStages, true>(steps, load, compute);
  } else {  // C/2 = 32 mod 64: the mma.sync 3x3 on the 1x1's warp tiles
    using R = Ring2<BN, S1, KS2, NT>;
    constexpr int kRow = R::kRow, kSlot = BN * kRow, kB = BN * (KS2 / 8) / kThreads;
    const int kpt = p.C2 / KS2;  // k-slices per tap
    const int ncn = p.oc_tile / BN;
    const int steps = (m2 + BM - 1) / BM * ncn * 9 * kpt;
    Cursor lc, cc;
    auto load = [&](int slot) {
      const __nv_bfloat16* src =
          p.w2t + ((long long)lc.tap * p.C + oc0 + lc.nc * BN) * p.C2 + lc.k * KS2;
      __nv_bfloat16* sb = ring + slot * kSlot;
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int row = i / (KS2 / 8), q = i % (KS2 / 8);
        cp_async16(smem_u32(sb + row * kRow + q * 8), src + (long long)row * p.C2 + q * 8, true);
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
            a[mi] = smem_u32(hid + idx * cs + (lane >> 4) * 8);
          }
        }
        uint32_t ak[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) ak[mi] = a[mi] + cc.k * KS2 * 2;
        mma_slice<KS2, kRow, DB, NT>(acc, ak, mt, smem_u32(ring + slot * kSlot + b_n * kRow + b_k));
        if (cc.k == kpt - 1 && cc.tap == 8) {
          // per m16 tile, every load of the residual first, then the stores
          // (y may alias x as far as the compiler knows)
          float2 bias[NT];
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
            bias[ni] = *reinterpret_cast<const float2*>(p.b2 + nbase + ni * 8 + 2 * tq);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            if (mi >= mt) continue;
            long long off[2];
            __nv_bfloat162 xv[2][NT];
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
                  xv[hh][ni] = *reinterpret_cast<const __nv_bfloat162*>(p.x + off[hh] + ni * 8);
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              if (off[hh] < 0) continue;
#pragma unroll
              for (int ni = 0; ni < NT; ++ni) {
                const float v0 = leaky(acc[mi][ni][hh * 2 + 0] + bias[ni].x);
                const float v1 = leaky(acc[mi][ni][hh * 2 + 1] + bias[ni].y);
                *reinterpret_cast<__nv_bfloat162*>(p.y + off[hh] + ni * 8) =
                    __floats2bfloat162_rn(__bfloat162float(xv[hh][ni].x) + v0,
                                          __bfloat162float(xv[hh][ni].y) + v1);
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
    auto* kernel = fused_residual_block_kernel<BN, KS2, MINB, S1, NT>;
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
  auto* kernel = fused_residual_block_kernel<BN, KS2, MINB, S1, NT>;
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

// The kernel for (warp_n, bn, C/2, smem).  64-channel warps (C/2 a multiple
// of 64, bn 128 or 256) run one block an SM; 32-channel warps take bn 64 or
// 128.  The 3x3 follows C/2 alone: a multiple of 64 takes 64-channel slices
// and wgmma, any other 32-channel slices and mma.sync
// (kernels/conv_block.py:conv3x3_path).
int dispatch(const Args& a, int warp_n, int bn, int blocks, int smem, cudaStream_t stream) {
  constexpr int S64 = ring_stages(64);
  const bool k64 = a.C2 % 64 == 0;
  if (warp_n == 64 && k64) {
    if (bn == 128) return run<128, 64, 1, S64, 8>(a, blocks, smem, stream);
    if (bn == 256) return run<256, 64, 1, S64, 8>(a, blocks, smem, stream);
  }
  if (warp_n == 32) {
    if (bn == 64)
      return k64 ? run32<64, 64>(a, blocks, smem, stream) : run32<64, 32>(a, blocks, smem, stream);
    if (bn == 128)
      return k64 ? run32<128, 64>(a, blocks, smem, stream)
                 : run32<128, 32>(a, blocks, smem, stream);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory of one block: the tile's hidden pixels (halo included,
// image pixels only) plus the zero pixel, then the ring.  The same formula
// as kernels/conv_block.py:smem_bytes.
extern "C" int amyolo_conv_block_smem_bytes(int H, int W, int C2, int strip, int col_tile,
                                            int warp_n, int bn) {
  const int hidden = (strip + 2 < H ? strip + 2 : H) * (col_tile + 2 < W ? col_tile + 2 : W) + 1;
  return 2 * hidden * (C2 + kPad) + ring_bytes(bn, warp_n);
}

// Resident blocks per SM of the kernel for (warp_n, bn, C/2) at `smem`
// bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA
// error.
extern "C" int amyolo_conv_block_blocks_per_sm(int warp_n, int bn, int C2, int smem) {
  Args a{};
  a.C2 = C2;
  return dispatch(a, warp_n, bn, 0, smem, nullptr);
}

// x, y: (B, H, W, C) bf16.  w1t: (C2, C) bf16 (out-channel major, input
// channel contiguous).  w2t: (9, C, C2) bf16, tap = 3*di + dj.  b1: (C2,)
// f32.  b2: (C,) f32.  C % 64 == 0, C2 = C / 2; every pointer 16-byte
// aligned.  One block per tile of strip rows x col_tile columns x oc_tile
// channels; warp_n (32 or 64) channels a warp, bn the block tile width;
// smem must equal amyolo_conv_block_smem_bytes.
extern "C" int amyolo_fused_residual_block(const void* x, const void* w1t, const void* b1,
                                           const void* w2t, const void* b2, void* y, int B,
                                           int H, int W, int C, int C2, int strip,
                                           int col_tile, int oc_tile, int warp_n, int bn,
                                           int smem, void* stream) {
  if (B <= 0 || C % 64 || C2 * 2 != C || oc_tile <= 0 || C % oc_tile || oc_tile % bn ||
      strip <= 0 || col_tile <= 0 || smem > kMaxSmem ||
      smem != amyolo_conv_block_smem_bytes(H, W, C2, strip, col_tile, warp_n, bn))
    return (int)cudaErrorInvalidValue;
  Args a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)w1t, (const float*)b1,
         (const __nv_bfloat16*)w2t, (const float*)b2, (__nv_bfloat16*)y,
         H, W, C, C2, strip, col_tile, oc_tile,
         (H + strip - 1) / strip, (W + col_tile - 1) / col_tile, C / oc_tile};
  const int blocks = B * a.n_strips * a.n_cols * a.n_oc;
  const int err = dispatch(a, warp_n, bn, blocks, smem, (cudaStream_t)stream);
  return err < 0 ? -err : err;
}
