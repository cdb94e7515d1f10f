// Eval-mode BatchNorm and the ReLU after it, in one pass, for Hopper
// (sm_90a), plain C interface.
//
// Replaces what the JAX package leaves to XLA's fusion: the inference
// branch of `BatchNorm.__call__` (backtoreality_tpu/nn/norm.py:54, its
// `(x - mean) * inv + bias`) and the `nn.relu` after it
// (backtoreality_tpu/nn/mlp.py:48). Over x (rows, C), channels last,
// contiguous, float32 or bfloat16:
//
//   y[r, c] = relu((x[r, c] - mean[c]) * inv[c] + bias[c])
//
// with mean, inv = rsqrt(var + eps) * weight and bias float32, inv computed
// by the caller (torch ops on the C-vector). Unfused, the same result is
// four elementwise passes (sub, mul, add, clamp), each reading and writing
// the whole activation: 32 bytes an element in float32. Here x is read once
// and y written once: 8 bytes an element (4 in bfloat16).
//
// Bit for bit the torch sequence of nn/norm.py with torch.relu after it:
// each step is rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn, which
// nvcc never contracts into an FMA, as it would `a * b + c` by default), and
// the ReLU is ATen's clamp_min: a NaN passes through, anything else is
// fmaxf(v, 0). ATen's sub is an add with alpha -1, a + (-1) * b; whether its
// build contracts that into an FMA or not, the product is exact and the
// result is a - b rounded once, as here. A bfloat16 x is widened exactly
// (its bits are a float32's high half), the arithmetic is float32's, and the
// result is rounded to bfloat16 by __float2bfloat16 (to nearest even, what
// `.to(torch.bfloat16)` runs on the card) before the ReLU, which torch.relu
// then takes in bfloat16: a NaN keeps its bfloat16 bits, anything else is
// fmaxf over the value widened again.
//
// What bounds it: bytes. The elements are flat, four a thread at a time (a
// float4, or a uint2 of four bfloat16; C is a multiple of 4, so the four
// never cross a row). The grid strides by a whole number of rows' fours (the
// launcher rounds the grid up to it), so a thread's four channels are the
// same in every iteration: it reads its mean, inv and bias once, into
// registers, and the loop is loads, the arithmetic and stores. Four loads
// are in flight before the first store. The grid fills the card: as many
// blocks as are resident at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// four elements of x or y in one access
template <typename T>
struct Four;
template <>
struct Four<float> {
  using type = float4;
};
template <>
struct Four<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 widen(float4 v) { return v; }

__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float bn1(float x, float mean, float inv,
                                     float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), inv), bias);
}

__device__ __forceinline__ float relu(float t) {
  return isnan(t) ? t : fmaxf(t, 0.0f);
}

// torch.relu of the bfloat16 that `.to(torch.bfloat16)` makes of t, as
// its bits
__device__ __forceinline__ unsigned relu_bf16(float t) {
  const __nv_bfloat16 r = __float2bfloat16(t);
  const float v = __bfloat162float(r);
  return __bfloat16_as_ushort(isnan(v) ? r : __float2bfloat16(fmaxf(v, 0.0f)));
}

__device__ __forceinline__ float4 narrow(float4 t, float4) {
  return make_float4(relu(t.x), relu(t.y), relu(t.z), relu(t.w));
}

__device__ __forceinline__ uint2 narrow(float4 t, uint2) {
  return make_uint2(relu_bf16(t.x) | relu_bf16(t.y) << 16,
                    relu_bf16(t.z) | relu_bf16(t.w) << 16);
}

template <typename V>
__device__ __forceinline__ V bn_relu4(V x, float4 mean, float4 inv,
                                      float4 bias) {
  const float4 w = widen(x);
  return narrow(make_float4(bn1(w.x, mean.x, inv.x, bias.x),
                            bn1(w.y, mean.y, inv.y, bias.y),
                            bn1(w.z, mean.z, inv.z, bias.z),
                            bn1(w.w, mean.w, inv.w, bias.w)),
                V());
}

// nvec fours of x; cvec fours a row. The launcher makes the grid's thread
// count a multiple of cvec.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_kernel(const typename Four<T>::type* __restrict__ x,
                   const float4* __restrict__ mean,
                   const float4* __restrict__ inv,
                   const float4* __restrict__ bias,
                   typename Four<T>::type* __restrict__ y, long long nvec,
                   int cvec) {
  using V = typename Four<T>::type;
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c = (int)(v % cvec);
  const float4 m = __ldg(mean + c), s = __ldg(inv + c), b = __ldg(bias + c);
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    V in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) in[u] = x[v + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      y[v + u * stride] = bn_relu4(in[u], m, s, b);
  }
  for (; v < nvec; v += stride) y[v] = bn_relu4(x[v], m, s, b);
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T>
int launch(const void* x, const float* mean, const float* inv,
           const float* bias, void* y, long long n, int c,
           cudaStream_t stream) {
  using V = typename Four<T>::type;
  static int resident = 0;  // blocks of the kernel an SM holds at once
  if (resident == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, bn_relu_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long nvec = n / 4;
  const int cvec = c / 4;
  // blocks in a whole number of rows' fours
  const long long unit = cvec / gcd(cvec, kThreads);
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long full = (long long)sms * resident;
  if (blocks > full) blocks = full;
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bn_relu_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(x), reinterpret_cast<const float4*>(mean),
      reinterpret_cast<const float4*>(inv),
      reinterpret_cast<const float4*>(bias), static_cast<V*>(y), nvec, cvec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (n / c, c), contiguous, float32 (bf16 == 0) 16-byte aligned or
// bfloat16 (bf16 != 0) 8-byte aligned; mean, inv, bias: (c,) float32,
// 16-byte aligned; c a multiple of 4. Returns the cudaError_t of the launch
// (0 on success).
int bn_relu_launch(const void* x, const float* mean, const float* inv,
                   const float* bias, void* y, long long n, int c, int bf16,
                   cudaStream_t stream) {
  if (c <= 0 || c % 4 != 0 || n % c != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return bf16 ? launch<__nv_bfloat16>(x, mean, inv, bias, y, n, c, stream)
              : launch<float>(x, mean, inv, bias, y, n, c, stream);
}

}  // extern "C"
