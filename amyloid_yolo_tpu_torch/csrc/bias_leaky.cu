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

// I: the index type, 32-bit where every index fits, else 64-bit.
template <bool BF16, typename I>
__global__ void __launch_bounds__(kThreads)
bias_leaky_kernel(typename Elem<BF16>::S* __restrict__ out,
                  const typename Elem<BF16>::S* __restrict__ bias,
                  I n, I n_vec, I inner, uint32_t C, float slope, int leaky) {
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
#pragma unroll
    for (int j = 0; j < V; ++j) {
      e[j] = epilogue<BF16>(e[j], E::get(__ldg(bias + c)), slope, leaky);
      if (++r == inner) {
        r = 0;
        if (++c == C) c = 0;
      }
    }
    memcpy(&raw, e, sizeof(raw));
    reinterpret_cast<uint4*>(out)[v] = raw;
  }
  for (I i = n_vec * V + first; i < n; i += stride) {
    const uint32_t c = (uint32_t)((i / inner) % C);
    out[i] = epilogue<BF16>(out[i], E::get(__ldg(bias + c)), slope, leaky);
  }
}

template <bool BF16, typename I>
void launch(void* out, const void* bias, long long n, long long inner, int C, float slope,
            int leaky, cudaStream_t stream) {
  using S = typename Elem<BF16>::S;
  constexpr int V = Elem<BF16>::kVec;
  const long long n_vec = ((uintptr_t)out % 16 == 0) ? n / V : 0;
  const long long work = n_vec + (n - n_vec * V);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long wave = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > wave) blocks = wave;
  bias_leaky_kernel<BF16, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (S*)out, (const S*)bias, (I)n, (I)n_vec, (I)inner, (uint32_t)C, slope, leaky);
}

}  // namespace

// out: n elements, C channels, `inner` elements a channel run (1: NHWC,
// H*W: NCHW); bias: C elements of out's dtype; bf16: 1 for bf16, 0 for
// float32; slope: 0.1 rounded to out's dtype.
extern "C" int amyolo_bias_leaky(void* out, const void* bias, long long n, int C,
                                 long long inner, int bf16, int leaky, float slope,
                                 void* stream) {
  if (n > 0 && C > 0 && inner > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool narrow = n < (1LL << 31);  // every index and index + stride fits in 32 bits
    if (bf16) {
      narrow ? launch<true, uint32_t>(out, bias, n, inner, C, slope, leaky, s)
             : launch<true, uint64_t>(out, bias, n, inner, C, slope, leaky, s);
    } else {
      narrow ? launch<false, uint32_t>(out, bias, n, inner, C, slope, leaky, s)
             : launch<false, uint64_t>(out, bias, n, inner, C, slope, leaky, s);
    }
  }
  return (int)cudaGetLastError();
}
