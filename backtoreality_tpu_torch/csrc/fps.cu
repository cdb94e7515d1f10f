// Furthest point sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels `_fps_kernel` (whole batch, one grid
// step) and `_fps_kernel_row` (one batch row per grid step) in
// backtoreality_tpu/ops/fps.py; both compute the same function, and this
// one kernel serves both.
//
// Semantics (bit-exact with `_fps_torch` in ops/fps.py):
//   * index 0 is always the first sample;
//   * a point with (x*x + y*y) + z*z <= 1e-3 is padding and is never
//     picked: its min-distance is pinned at -1 (< any distance >= 0);
//   * each further sample is the argmax of the running min-distance, ties
//     to the lowest index; an all-padding row gives index 0 throughout.
//   The squared distance is rounded as (dx*dx + dy*dy) + dz*dz with no
//   fused multiply-add (__fmul_rn / __fadd_rn): a contracted FMA changes
//   the last bit and flips argmax ties over thousands of iterations.
//
// What bounds it: the npoint iterations are strictly sequential, and each
// one sweeps the whole row (N distance updates, then one block-wide
// argmax). Operations are tiny (about 9 flops per point per iteration);
// the time goes to the sweep's loads and to the two block barriers per
// iteration.
//
// Design: one block per batch row, so the argmax is a block reduction
// (warp shuffles, then one warp over the per-warp winners) and the row's
// state never leaves the SM between iterations. The min-distance field
// lives in shared memory for all iterations. When the row's coordinates
// fit as well (16 bytes a point: SA2-SA4 and vote clustering), they are
// staged in shared memory too; otherwise (SA1, N=40000: the field alone
// is 160 KB of the 227 KB a block may have) each sweep re-reads them
// through L2, where the whole batch (B*N*12 bytes) stays resident. Rows
// whose field does not fit in shared memory keep it in a global scratch
// buffer that the wrapper allocates. Only B blocks run, so most SMs are
// idle: spreading one row over a thread-block cluster (DSMEM argmax) is
// the next step for speed.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr float kPadNorm2 = 1e-3f;
constexpr float kBig = 1e10f;
constexpr int kStaticSmem = 1024;  // room kept for the static arrays

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (v, i) <- the better of (v, i) and (ov, oi): larger value, then lower
// index.
__device__ __forceinline__ void keep_best(float& v, int& i, float ov,
                                          int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    keep_best(v, i, ov, oi);
  }
}

template <bool kStaged>
__global__ void fps_kernel(const float* __restrict__ xyz, long long sb,
                           long long sn, int n, int npoint,
                           int* __restrict__ out, float* __restrict__ gfield) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;
  const float* row = xyz + b * sb;
  float* mind = gfield != nullptr ? gfield + (long long)b * n : smem;
  float* sx = smem + n;  // staged coordinates (kStaged only)
  float* sy = sx + n;
  float* sz = sy + n;

  for (int i = tid; i < n; i += nt) {
    const float* p = row + i * sn;
    float x = p[0], y = p[1], z = p[2];
    mind[i] = sq3(x, y, z) > kPadNorm2 ? kBig : -1.0f;
    if (kStaged) {
      sx[i] = x;
      sy[i] = y;
      sz[i] = z;
    }
  }
  if (tid == 0) out[(long long)b * npoint] = 0;
  int last = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    float rx, ry, rz;
    if (kStaged) {
      rx = sx[last];
      ry = sy[last];
      rz = sz[last];
    } else {
      const float* p = row + last * sn;
      rx = p[0];
      ry = p[1];
      rz = p[2];
    }
    float bv = -FLT_MAX;
    int bi = n;
    for (int i = tid; i < n; i += nt) {
      float x, y, z;
      if (kStaged) {
        x = sx[i];
        y = sy[i];
        z = sz[i];
      } else {
        const float* p = row + i * sn;
        x = __ldg(p);
        y = __ldg(p + 1);
        z = __ldg(p + 2);
      }
      float d = sq3(__fsub_rn(x, rx), __fsub_rn(y, ry), __fsub_rn(z, rz));
      float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > bv) {  // i only grows within a thread: keeps the first max
        bv = m;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -FLT_MAX;
      bi = lane < nwarps ? red_i[lane] : n;
      warp_best(bv, bi);
      if (lane == 0) {
        s_last = bi;
        out[(long long)b * npoint + j] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes - kStaticSmem;
}

}  // namespace

extern "C" {

// 1 if a row of n points needs the global min-distance scratch (B*n
// floats) because its field does not fit in shared memory, else 0.
int fps_needs_scratch(int n) { return 4LL * n > max_smem() ? 1 : 0; }

// xyz: row b, point i, coordinate k at xyz[b*sb + i*sn + k] (float32).
// out: (b, npoint) int32, contiguous. scratch: (b, n) float32 or NULL.
// Returns the cudaError_t of the launch (0 on success).
int fps_launch(const float* xyz, long long sb, long long sn, int b, int n,
               int npoint, int* out, float* scratch, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  const int limit = max_smem();
  int threads = ((n / 8 + 31) / 32) * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (16LL * n <= limit) {
    size_t bytes = 16ull * n;
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    fps_kernel<true><<<b, threads, bytes, s>>>(xyz, sb, sn, n, npoint, out,
                                               nullptr);
  } else if (4LL * n <= limit) {
    size_t bytes = 4ull * n;
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    fps_kernel<false><<<b, threads, bytes, s>>>(xyz, sb, sn, n, npoint, out,
                                                nullptr);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    fps_kernel<false><<<b, threads, 0, s>>>(xyz, sb, sn, n, npoint, out,
                                            scratch);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
