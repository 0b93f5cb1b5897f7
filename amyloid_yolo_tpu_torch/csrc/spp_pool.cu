// SPP: YOLOv4's stride-1 max-pools and the route that joins them with
// their input, in one pass that writes the joined map.
//
// Replaces no Pallas kernel: on the TPU XLA ran each reduce_window and the
// concatenate.  Here it takes the place of three max_pool2d kernels and the
// route's torch.cat.  In YOLOv4 the input is a (B, 512, 19, 19) map, the
// pools are 5, 9 and 13 wide with (k - 1) / 2 of implicit -inf padding (a
// window is clipped to the map), and the route joins [max13, max9, max5,
// input] into 2048 channels.  Both maps are NHWC in memory (channels_last).
//
// What max_pool2d computes, bit for bit: it walks each window in raster
// order (row by row, left to right) and takes a value v over the running m
// where v > m or v is NaN, from m = -inf.  So a window gives its last NaN if
// it holds one, else its first maximum (which decides between -0.0 and
// +0.0).  Call that result the window's fold.  For two runs A and B of a
// row, A starting the union and B ending it (they may overlap),
//
//   fold(A u B) = later_wins(fold(A), fold(B)),
//   later_wins(a, b) = (b > a || b is NaN) ? b : a,
//
// and a window's raster order is its rows in order, so the pool is a fold
// along each row and then a fold down the column of those row folds.  Along
// one axis the folds of radius r grow to radius r + d (d <= r) in one step,
// later_wins(f_r[i - d], f_r[i + d]) with the indices clamped to the map
// (a clamped run still starts or ends the clipped window): radius 1 from
// three taps, then 2, 4, 6.  The 5, 9 and 13 pools take 4 steps along the
// rows (0 -> 1 -> 2, -> 4, -> 6, kept from one pool to the next) and 2, 3
// and 4 down the columns, one later_wins an element a step, where
// max_pool2d compares 25, 81 and 169 values an output.
//
// The design: one block per (image, tile of the map, run of 2 x 16 bytes of
// channels a pixel: 16 bf16 or 8 float32).  A tile is the pixels a block
// writes plus a halo of the widest pool's radius R on each side that the
// map has; a fold of radius r <= R at a written pixel reads only pixels of
// its tile, and where a step's index is clamped at the tile's edge that edge
// is the map's.  The block copies the tile of its run into shared memory
// (cp.async, 16 bytes a copy), writes the input's slice of the output, then
// runs the steps between three tile buffers, each step one pass of the
// block over the tile with a barrier after it; each pool's last column step
// stores to the pool's slice with 16-byte stores.  bf16 pairs compare in
// one set.gt and one set.nan on bf16x2 whose masks select the bits; nothing
// is rounded.  A tile loads at most kTilePixels pixels (48 KB of buffers);
// a map that fits is one tile with no halo (YOLOv4's 19^2 at 608: 34.7 KB,
// six blocks an SM), a larger one takes the tiles that load the fewest
// pixels in all.
//
// Bound on an H100: memory, the input read once and the joined map written
// once.  At B=64, 512 channels and 19^2 in bf16 that is 23.66 MB in and
// 94.63 MB out, 0.035 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kVectors = 2;       // 16-byte vectors of channels a pixel in one block
constexpr int kMaxPools = 4;      // kernels/spp_pool.py's MAX_POOLS
constexpr int kBuffers = 3;
constexpr int kTilePixels = 512;  // kBuffers x 32 bytes a pixel: 48 KB

struct Pools {
  int n;
  int radius[kMaxPools];   // ascending
  int offset[kMaxPools];   // the channel of each pool's slice in the output
  int in_offset;           // the channel of the input's slice
};

template <bool BF16> struct Elem;

template <> struct Elem<true> {
  using S = uint16_t;
  static constexpr int kVec = 8;
  // later_wins on the two bf16 halves of a and b
  __device__ static uint32_t later_wins(uint32_t a, uint32_t b) {
    uint32_t gt, nan;
    asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(b), "r"(a));
    asm("set.nan.u32.bf16x2 %0, %1, %1;" : "=r"(nan) : "r"(b));
    const uint32_t m = gt | nan;
    return (b & m) | (a & ~m);
  }
};

template <> struct Elem<false> {
  using S = float;
  static constexpr int kVec = 4;
  __device__ static uint32_t later_wins(uint32_t a, uint32_t b) {
    const float fa = __uint_as_float(a), fb = __uint_as_float(b);
    return (fb > fa || fb != fb) ? b : a;
  }
};

template <bool BF16>
__device__ __forceinline__ uint4 later_wins(uint4 a, uint4 b) {
  using E = Elem<BF16>;
  return make_uint4(E::later_wins(a.x, b.x), E::later_wins(a.y, b.y),
                    E::later_wins(a.z, b.z), E::later_wins(a.w, b.w));
}

// A block's tile: lh x lw pixels of the map, of which it writes rows
// [y0, y1) and columns [x0, x1) (the tile's own coordinates).  Element e of
// a buffer is vector e % 2 of pixel e / 2 (row y, column x); the run holds
// cv <= 2 vectors of real channels.
struct Tile {
  int lh, lw, y0, y1, x0, x1, cv;
  float inv_w;   // 1 / lw: y = floor((p + 1/2) / lw), exact below kTilePixels
  __device__ int n() const { return lh * lw * kVectors; }
  __device__ void at(int e, int& y, int& x, int& v) const {
    v = e & (kVectors - 1);
    const int p = e / kVectors;
    y = __float2int_rz(((float)p + 0.5f) * inv_w);
    x = p - y * lw;
  }
  __device__ bool writes(int y, int x, int v) const {
    return v < cv && y >= y0 && y < y1 && x >= x0 && x < x1;
  }
};

constexpr int kThreeTaps = 0;

// One step along the rows (ROW) or down the columns: from the folds of
// radius r in src to radius r + d (d <= r), or with d == kThreeTaps from the
// map to radius 1; into dst, or to the output at channel off where dst is
// null (out at the tile's first pixel, W the map's pixels a row).
template <bool BF16, bool ROW>
__device__ __forceinline__ void step(const Tile& t, const uint4* __restrict__ src,
                                     uint4* __restrict__ dst,
                                     typename Elem<BF16>::S* __restrict__ out, int W, int OC,
                                     int off, int d) {
  constexpr int V = Elem<BF16>::kVec;
  const int n = t.n();
  const int len = ROW ? t.lw : t.lh;
  const int stride = ROW ? kVectors : t.lw * kVectors;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    int y, x, v;
    t.at(e, y, x, v);
    const int pos = ROW ? x : y;
    uint4 m;
    if (d == kThreeTaps) {
      m = src[e];
      if (pos > 0) m = later_wins<BF16>(src[e - stride], m);
      if (pos < len - 1) m = later_wins<BF16>(m, src[e + stride]);
    } else {
      const int lo = max(0, pos - d) - pos, hi = min(len - 1, pos + d) - pos;
      m = later_wins<BF16>(src[e + lo * stride], src[e + hi * stride]);
    }
    if (dst != nullptr) {
      dst[e] = m;
    } else if (t.writes(y, x, v)) {
      *reinterpret_cast<uint4*>(out + ((size_t)y * W + x) * OC + off + v * V) = m;
    }
  }
}

// The step from radius r towards t: its d, and r after it.
__device__ __forceinline__ int next_d(int r, int t) { return r == 0 ? kThreeTaps : min(r, t - r); }
__device__ __forceinline__ int grown(int r, int d) { return d == kThreeTaps ? 1 : r + d; }

// grid = (B x tiles, channel runs); a tile writes th x tw pixels; shared
// memory kBuffers tiles of the largest size.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
spp_pool_kernel(const typename Elem<BF16>::S* __restrict__ in,
                typename Elem<BF16>::S* __restrict__ out,
                int C, int OC, int H, int W, int th, int tw, Pools pools) {
  using S = typename Elem<BF16>::S;
  constexpr int V = Elem<BF16>::kVec;
  extern __shared__ uint4 smem[];
  const int R = pools.radius[pools.n - 1];
  const int tiles_x = (W + tw - 1) / tw, tiles = tiles_x * ((H + th - 1) / th);
  const int img = blockIdx.x / tiles, ti = blockIdx.x - img * tiles;
  const int oy = (ti / tiles_x) * th, ox = (ti % tiles_x) * tw;   // the first written pixel
  const int ty = max(0, oy - R), tx = max(0, ox - R);              // the tile's first pixel
  const int c0 = blockIdx.y * kVectors * V;
  Tile t;
  t.lh = min(H, oy + th + R) - ty;
  t.lw = min(W, ox + tw + R) - tx;
  t.y0 = oy - ty;
  t.y1 = min(H, oy + th) - ty;
  t.x0 = ox - tx;
  t.x1 = min(W, ox + tw) - tx;
  t.cv = min(kVectors, (C - c0) / V);
  t.inv_w = 1.0f / (float)t.lw;
  const int n = t.n();
  const size_t first = (size_t)img * H * W + (size_t)ty * W + tx;
  const S* src = in + first * C + c0;
  S* dst = out + first * OC + c0;

  for (int e = threadIdx.x; e < n; e += kThreads) {
    int y, x, v;
    t.at(e, y, x, v);
    if (v < t.cv) {
      const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem + e);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(s), "l"(src + ((size_t)y * W + x) * C + v * V));
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads) {
    int y, x, v;
    t.at(e, y, x, v);
    if (t.writes(y, x, v))
      *reinterpret_cast<uint4*>(dst + ((size_t)y * W + x) * OC + pools.in_offset + v * V) =
          smem[e];
  }

  auto other = [](int b, int not_b) {   // a buffer that is neither b nor not_b
    for (int i = 0; i < kBuffers; ++i)
      if (i != b && i != not_b) return i;
    return 0;
  };
  int cur = 0, r = 0;   // smem tile cur holds the row folds of radius r
  for (int k = 0; k < pools.n; ++k) {
    const int target = pools.radius[k];
    while (r < target) {
      const int d = next_d(r, target), nxt = other(cur, cur);
      step<BF16, true>(t, smem + cur * n, smem + nxt * n, nullptr, 0, 0, 0, d);
      __syncthreads();
      cur = nxt;
      r = grown(r, d);
    }
    for (int a = cur, rc = 0; rc < target;) {
      const int d = next_d(rc, target);
      rc = grown(rc, d);
      if (rc == target) {
        step<BF16, false>(t, smem + a * n, nullptr, dst, W, OC, pools.offset[k], d);
      } else {
        const int b = other(a, cur);
        step<BF16, false>(t, smem + a * n, smem + b * n, nullptr, 0, 0, 0, d);
        __syncthreads();
        a = b;
      }
    }
    __syncthreads();   // the next row step writes over a buffer read here
  }
}

// The th x tw pixels a tile writes on an H x W map with a halo of R: of the
// tiles that load at most kTilePixels pixels, those that load the fewest in
// all, the widest among them.  False where none fits.
bool choose_tile(int H, int W, int R, int& th, int& tw) {
  long long best = -1;
  for (int w = 1; w <= W; ++w) {
    const int lw = std::min(W, w + 2 * R), rows = kTilePixels / lw;
    const int h = rows >= H ? H : rows - 2 * R;
    if (h < 1) continue;
    const long long loaded = (long long)((H + h - 1) / h) * ((W + w - 1) / w) *
                             std::min(H, h + 2 * R) * lw;
    if (best < 0 || loaded <= best) {
      best = loaded;
      th = h;
      tw = w;
    }
  }
  return best >= 0;
}

}  // namespace

// in: (B, H, W, C) NHWC, C a multiple of 16 bytes (8 bf16, 4 float32);
// out: (B, H, W, OC) NHWC, each of the n pools' slices and the input's C
// channels wide at its channel offset; radius: the pools' (k - 1) / 2,
// ascending from 1, with offset their slices' channels; bf16: 1 for bf16,
// 0 for float32.
extern "C" int amyolo_spp_pool(const void* in, void* out, int B, int C, int H, int W, int OC,
                               int n, const int* radius, const int* offset, int in_offset,
                               int bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || n < 1 || n > kMaxPools)
    return (int)cudaErrorInvalidValue;
  Pools pools;
  pools.n = n;
  pools.in_offset = in_offset;
  for (int k = 0; k < n; ++k) {
    if (radius[k] < 1 || (k > 0 && radius[k] < radius[k - 1])) return (int)cudaErrorInvalidValue;
    pools.radius[k] = radius[k];
    pools.offset[k] = offset[k];
  }
  const int R = radius[n - 1];
  int th = 0, tw = 0;
  if (!choose_tile(H, W, R, th, tw)) return (int)cudaErrorInvalidValue;
  const int tiles = ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const int per_run = kVectors * (bf16 ? 8 : 4);
  const dim3 grid((unsigned)(B * tiles), (unsigned)((C + per_run - 1) / per_run));
  const size_t bytes =
      (size_t)kBuffers * std::min(H, th + 2 * R) * std::min(W, tw + 2 * R) * kVectors * 16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    spp_pool_kernel<true><<<grid, kThreads, bytes, s>>>(
        (const uint16_t*)in, (uint16_t*)out, C, OC, H, W, th, tw, pools);
  } else {
    spp_pool_kernel<false><<<grid, kThreads, bytes, s>>>(
        (const float*)in, (float*)out, C, OC, H, W, th, tw, pools);
  }
  return (int)cudaGetLastError();
}
