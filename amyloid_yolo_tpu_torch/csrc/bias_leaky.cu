// The epilogue of a library convolution: its bias, then the leaky ReLU, in
// place, in one pass over the conv's output (bf16 or float32).
//
// Replaces no Pallas kernel: on the TPU, XLA fused the bias and the leaky
// into the convolution.  Here cuDNN runs the conv (its fused
// conv-bias-activation has no leaky ReLU), and this kernel takes the place
// of the four PyTorch elementwise passes that followed it (the bias add,
// the compare, the multiply and the where) with the same roundings:
//
//   t = round(float(v) + float(b[c]))
//   y = t >= 0 ? t : round(float(t) * float(slope))    (a linear conv: y = t)
//
// round() is to the tensor's dtype (__float2bfloat16_rn; none in float32),
// slope is 0.1 rounded to that dtype by the caller, and the add and the
// multiply are spelt __fadd_rn/__fmul_rn so that nvcc contracts nothing.
// -0.0 stays -0.0 (it is >= 0); NaN takes the multiply, as torch.where
// sends it.
//
// Bound on an H100: memory, at 0.25 FLOP a byte.  Each element is read once
// and written once: at B=64 and 416 the 29 convs outside the residual units
// write 1.06e9 bf16 elements a call, 4.24 GB of traffic, 1.27 ms at
// 3.35 TB/s.  The design does nothing but move those bytes at full width:
// 16-byte loads and stores (8 bf16 or 4 float32 values a thread), a
// grid-stride loop over one wave of blocks, the bias (at most 1024
// channels) through the read-only cache, and the channel worked out once a
// vector and then walked element by element.  In NHWC memory the channel of
// element i is i % C; in NCHW it is (i / HW) % C, `inner` being 1 or HW.
// The 21-channel head outputs do not divide into vectors by channel, hence
// the walk.  A scalar loop takes the tail, and every element of an output
// whose pointer is not 16-byte aligned.
//
// bias_mish_kernel is the same pass for YOLOv4's Mish convs, over the same
// loop (each_element): the bias is added and rounded as above, then
//
//   y = round(mish(float(t))),  mish(t) = t·n/(n + 2),  n = e^t·(e^t + 2)
//
// which is t·tanh(softplus(t)) written with one exp and one division, and t
// itself above 20 (softplus's threshold in darknet's MISH_THRESHOLD and in
// PyTorch).  The exp is expf (no flush of subnormals); the division is
// __fdividef, whose divisor here stays under 2^58.  Its contract with
// bias_mish_plain (F.mish, which takes tanh and log1p) is one bf16 ulp: the
// two float32 values may differ by a few float32 ulps, and their bf16
// roundings then differ where they straddle a rounding boundary (none of
// 189.6 M elements did over YOLOv4's 72 Mish shapes at B=2 on an H100).
// At B=64 and 608 YOLOv4's 72 Mish convs write 6.07e9 bf16 elements a call,
// 24.27 GB read and written, 7.25 ms at 3.35 TB/s; the arithmetic (an exp
// and a reciprocal on the special-function units, a dozen FP32
// instructions) stays under that.
//
// Into a route's slice (INTO, the Mish pass only): an NHWC output can be
// written to another tensor, `dst`, whose pixels lie `ld` >= C elements
// apart with their C channels contiguous: the channel slice of a route's
// map that the conv is a member of.  The values and their rounding points are the in-place
// pass's; only where they land differs, at pixel·ld + c instead of
// pixel·C + c, so the route needs no copy of its members.  The 16-byte
// vectors need both pointers 16-byte aligned and C and ld whole vectors (a
// vector then lies in one pixel); anything else takes the scalar loop.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: a full SM

template <bool BF16> struct Elem;

template <> struct Elem<true> {   // bf16, held as its bits
  using S = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float get(S s) { return __uint_as_float((uint32_t)s << 16); }
  __device__ static S put(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
};

template <> struct Elem<false> {  // float32
  using S = float;
  static constexpr int kVec = 4;
  __device__ static float get(S s) { return s; }
  __device__ static S put(float f) { return f; }
};

template <bool BF16>
__device__ __forceinline__ typename Elem<BF16>::S epilogue(typename Elem<BF16>::S v, float b,
                                                           float slope, bool leaky) {
  using E = Elem<BF16>;
  const typename E::S t = E::put(__fadd_rn(E::get(v), b));
  const float tf = E::get(t);
  return (leaky && !(tf >= 0.0f)) ? E::put(__fmul_rn(tf, slope)) : t;
}

// softplus's threshold: above it mish(t) is t in float32
constexpr float kMishThreshold = 20.0f;

__device__ __forceinline__ float mish(float t) {
  if (t > kMishThreshold) return t;
  const float e = expf(t);
  const float n = __fmul_rn(e, __fadd_rn(e, 2.0f));
  return __fdividef(__fmul_rn(t, n), __fadd_rn(n, 2.0f));
}

template <bool BF16> struct LeakyOp {
  float slope;
  int leaky;
  __device__ typename Elem<BF16>::S operator()(typename Elem<BF16>::S v, float b) const {
    return epilogue<BF16>(v, b, slope, leaky);
  }
};

template <bool BF16> struct MishOp {
  __device__ typename Elem<BF16>::S operator()(typename Elem<BF16>::S v, float b) const {
    using E = Elem<BF16>;
    return E::put(mish(E::get(E::put(__fadd_rn(E::get(v), b)))));
  }
};

// The pass over out: op(element, its channel's bias) written back in place,
// or with INTO (NHWC only, inner == 1) to dst at pixel·ld + c.
// I: the index type, 32-bit where every index fits, else 64-bit.
template <bool BF16, bool INTO, typename I, typename Op>
__device__ __forceinline__ void each_element(typename Elem<BF16>::S* __restrict__ out,
                                             typename Elem<BF16>::S* __restrict__ dst,
                                             const typename Elem<BF16>::S* __restrict__ bias,
                                             I n, I n_vec, I inner, uint32_t C, I ld, Op op) {
  using E = Elem<BF16>;
  using S = typename E::S;
  constexpr int V = E::kVec;
  const I stride = (I)gridDim.x * kThreads;
  const I first = (I)blockIdx.x * kThreads + threadIdx.x;
  for (I v = first; v < n_vec; v += stride) {
    const I i = v * V;
    const I q = i / inner;
    I r = i - q * inner;
    uint32_t c = (uint32_t)(q % C);
    uint4 raw = reinterpret_cast<const uint4*>(out)[v];
    S e[V];
    memcpy(e, &raw, sizeof(raw));
    // INTO: C is whole vectors, so the vector lies in pixel q / C
    S* const to = INTO ? dst + (q / C) * ld + c : out + i;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      e[j] = op(e[j], E::get(__ldg(bias + c)));
      if (++r == inner) {
        r = 0;
        if (++c == C) c = 0;
      }
    }
    memcpy(&raw, e, sizeof(raw));
    *reinterpret_cast<uint4*>(to) = raw;
  }
  for (I i = n_vec * V + first; i < n; i += stride) {
    const I q = i / inner;
    const uint32_t c = (uint32_t)(q % C);
    const S y = op(out[i], E::get(__ldg(bias + c)));
    if (INTO) {
      dst[(q / C) * ld + c] = y;
    } else {
      out[i] = y;
    }
  }
}

template <bool BF16, typename I>
__global__ void __launch_bounds__(kThreads)
bias_leaky_kernel(typename Elem<BF16>::S* __restrict__ out,
                  const typename Elem<BF16>::S* __restrict__ bias,
                  I n, I n_vec, I inner, uint32_t C, float slope, int leaky) {
  each_element<BF16, false, I>(out, nullptr, bias, n, n_vec, inner, C, (I)0,
                               LeakyOp<BF16>{slope, leaky});
}

template <bool BF16, bool INTO, typename I>
__global__ void __launch_bounds__(kThreads)
bias_mish_kernel(typename Elem<BF16>::S* __restrict__ out,
                 typename Elem<BF16>::S* __restrict__ dst,
                 const typename Elem<BF16>::S* __restrict__ bias,
                 I n, I n_vec, I inner, uint32_t C, I ld) {
  each_element<BF16, INTO, I>(out, dst, bias, n, n_vec, inner, C, ld, MishOp<BF16>{});
}

// The activations of the one entry point.
enum Act { kLinear = 0, kLeaky = 1, kMish = 2 };

// One pass of act over out: one wave of blocks at most, over the 16-byte
// vectors (none where a pointer is not 16-byte aligned, or where dst is given
// and C or ld is not whole vectors) and the scalar tail.
template <bool BF16, typename I>
void launch(void* out, void* dst, long long ld, const void* bias, long long n, long long inner,
            int C, int act, float slope, cudaStream_t stream) {
  using S = typename Elem<BF16>::S;
  constexpr int V = Elem<BF16>::kVec;
  const bool vec = (uintptr_t)out % 16 == 0
      && (!dst || ((uintptr_t)dst % 16 == 0 && C % V == 0 && ld % V == 0));
  const long long n_vec = vec ? n / V : 0;
  const long long work = n_vec + (n - n_vec * V);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long wave = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > wave) blocks = wave;
  if (act != kMish) {
    bias_leaky_kernel<BF16, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (S*)out, (const S*)bias, (I)n, (I)n_vec, (I)inner, (uint32_t)C, slope, act == kLeaky);
  } else if (dst) {
    bias_mish_kernel<BF16, true, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (S*)out, (S*)dst, (const S*)bias, (I)n, (I)n_vec, (I)inner, (uint32_t)C, (I)ld);
  } else {
    bias_mish_kernel<BF16, false, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (S*)out, nullptr, (const S*)bias, (I)n, (I)n_vec, (I)inner, (uint32_t)C, (I)0);
  }
}

}  // namespace

// out: n elements, C channels, `inner` elements a channel run (1: NHWC,
// H*W: NCHW); dst: NULL to write out in place, else (Mish and NHWC only)
// where the results go, each pixel's C values at dst + pixel*ld, ld >= C;
// bias: C elements of out's dtype; bf16: 1 for bf16, 0 for float32; act: 0
// linear (the bias alone), 1 leaky, 2 Mish; slope (leaky only): 0.1 rounded
// to out's dtype.
extern "C" int amyolo_bias_act(void* out, void* dst, long long ld, const void* bias,
                               long long n, int C, long long inner, int bf16, int act,
                               float slope, void* stream) {
  if (dst && (act != kMish || inner != 1 || ld < C)) return (int)cudaErrorInvalidValue;
  if (n > 0 && C > 0 && inner > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    // every index and index + stride fits in 32 bits, in out and in dst
    const bool narrow = n < (1LL << 31) && (!dst || n / C * ld < (1LL << 31));
    if (bf16) {
      narrow ? launch<true, uint32_t>(out, dst, ld, bias, n, inner, C, act, slope, s)
             : launch<true, uint64_t>(out, dst, ld, bias, n, inner, C, act, slope, s);
    } else {
      narrow ? launch<false, uint32_t>(out, dst, ld, bias, n, inner, C, act, slope, s)
             : launch<false, uint64_t>(out, dst, ld, bias, n, inner, C, act, slope, s);
    }
  }
  return (int)cudaGetLastError();
}
