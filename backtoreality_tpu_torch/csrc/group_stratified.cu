// Stratified grouping for Hopper (sm_90a), forward and backward, plain C
// interface.
//
// Replaces the Pallas TPU kernel `_group_bucketed_kernel` in
// backtoreality_tpu/ops/grouping.py (launched by `_group_bucketed_pallas`,
// with its custom VJP and the first-hit repair of
// `group_points_stratified`).
//
// Forward: grouped[b, m, s, :] = points[b, idx[b, m, s], :], for any
// channel count C. The TPU kernel builds a one-hot per stratum and reduces
// it against the stratum's points (a matrix-unit form of a gather), and
// then repairs the slot-filled entries from the first-hit slot; the result
// is this gather, which a GPU does directly. It is a copy, so it equals
// the plain version bit for bit.
//
// Backward: grad_points[b, n, :] = sum of grad_out[b, m, s, :] over every
// (m, s) with idx[b, m, s] == n, computed without float atomics, in a fixed
// order, so two runs give bitwise-equal results. It follows the JAX VJP
// (the one-hot contraction per stratum plus the repair's transpose), in
// two passes:
//
//   1. fold (one thread per (b, m, c)): for centre m, the gradients of
//      its slot-filled slots (hit == false) are summed in slot order into
//      fold[b, m, :], and first[b, m] records the first-hit slot (0 for a
//      centre with no hit). A filled slot holds the index of that first
//      hit, so its gradient belongs to the same point.
//   2. reduce (one block per (b, stratum t, slice of kChunk channels)):
//      centre m contributes to the point idx[b, m, t] of stratum t when
//      slot t is a hit, and its fold when t == first[b, m]. The block
//      lists the contributing centres of each point of the stratum in
//      increasing m (a counting sort whose placement runs in m order,
//      warp by warp), then one thread per (point, channel) sums its list
//      in that order: for each m, grad_out[b, m, t, c] (if a hit) and
//      then fold[b, m, c] (if first). Every point of the stratum is
//      written, zero where nothing lands. The list does not depend on
//      the channel slice, so each slice's block builds the same one; a
//      slice of 32 gives one warp per point's list, and at C = 131/259
//      five to nine times the blocks of one block per stratum.
//
// The only place a point outside stratum t could show up in slot t is a
// filled slot, which pass 2 never reads; the one exception is slot 0 of a
// centre with no hit (index 0, in stratum 0), which pass 2 counts through
// the fold and never as a hit. Precondition: idx and hit come from the
// stratified ball query (slot-filled with the first hit, index 0 for a
// centre with no hit); bucket * nsample >= n.
//
// What bounds it: bytes. Both directions do no arithmetic worth counting
// (one add per gradient element); the forward reads idx and writes
// B*M*S*C floats, the backward reads grad_out, idx and hit once and writes
// B*N*C floats. The forward's point rows are re-read through L1/L2 (the
// same points are picked by many centres). The backward's counting sort
// lives in shared memory: 3*M + 2*bucket + 1 ints per block. Index math
// is 32-bit where every offset fits (all of the model's shapes), 64-bit
// otherwise; the forward moves a float4 per thread when C % 4 == 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // channels per reduce block
// below this, an offset plus a grid's stride still fits in an int
constexpr long long kInt32Limit = (1LL << 31) - (1LL << 24);

// T: float, or float4 (c then counts float4s); I: the index type, int
// when every offset fits, else long long
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    group_fwd_kernel(const T* __restrict__ points,
                     const int* __restrict__ idx, I rows_per_b, I n, I c,
                     I total, T* __restrict__ out) {
  for (I e = (I)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (I)gridDim.x * kThreads) {
    const I row = e / c;  // (b, m, s) flattened
    const I ch = e - row * c;
    const I b = row / rows_per_b;
    const I p = __ldg(idx + row);
    out[e] = __ldg(points + (b * n + p) * c + ch);
  }
}

// pass 1: fold slot-filled gradients of each centre into one row
__global__ void __launch_bounds__(kThreads)
    group_bwd_fold_kernel(const float* __restrict__ gout,
                          const unsigned char* __restrict__ hit,
                          long long rows, int nsample, int c,
                          float* __restrict__ fold,
                          int* __restrict__ first) {
  const long long total = rows * c;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long row = e / c;  // (b, m) flattened
    const int ch = (int)(e - row * c);
    const unsigned char* h = hit + row * nsample;
    const float* g = gout + row * nsample * c + ch;
    float acc = 0.f;
    int f = -1;
    for (int s = 0; s < nsample; ++s) {
      if (h[s]) {
        if (f < 0) f = s;
      } else {
        acc += g[(long long)s * c];
      }
    }
    fold[e] = acc;
    if (ch == 0) first[row] = f < 0 ? 0 : f;
  }
}

// list entries: centre index | hit flag | first-slot flag
constexpr int kHitBit = 1 << 30;
constexpr int kFirstBit = 1 << 29;
constexpr int kIndexMask = kFirstBit - 1;

// pass 2: per (b, stratum), ordered segmented reduction
__global__ void __launch_bounds__(kThreads)
    group_bwd_reduce_kernel(const float* __restrict__ gout,
                            const float* __restrict__ fold,
                            const int* __restrict__ idx,
                            const unsigned char* __restrict__ hit,
                            const int* __restrict__ first, int n, int m,
                            int nsample, int bucket, int c,
                            float* __restrict__ grad) {
  extern __shared__ int smem[];
  int* tag = smem;                 // m: list entry, or -1
  int* target = tag + m;           // m: offset in the stratum, or -1
  int* list = target + m;          // m: entries ordered by (offset, m)
  int* start = list + m;           // bucket + 1: segment starts
  int* cursor = start + bucket + 1;  // bucket: counts, then cursors

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int c0 = blockIdx.z * kChunk;
  const int width = min(kChunk, c - c0);
  const int lo = t * bucket;
  if (lo >= n) return;  // the stratum is all padding: no point to write
  const int len = min(bucket, n - lo);
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  for (int k = tid; k < bucket; k += kThreads) cursor[k] = 0;
  __syncthreads();

  // which point of this stratum each centre's slot t feeds
  for (int i = tid; i < m; i += kThreads) {
    const long long row = (long long)b * m + i;
    const long long o = row * nsample + t;
    const bool h = hit[o] != 0;
    const bool f = first[row] == t;
    int k = -1;
    if (h || f) {
      k = idx[o] - lo;
      if (k < 0 || k >= len) k = -1;  // outside the precondition: skip
    }
    target[i] = k;
    tag[i] = i | (h ? kHitBit : 0) | (f ? kFirstBit : 0);
    if (k >= 0) atomicAdd(&cursor[k], 1);  // integer count: exact
  }
  __syncthreads();

  // exclusive scan of the counts (warp 0, 32 at a time)
  if (tid < 32) {
    int carry = 0;
    for (int base = 0; base < bucket; base += 32) {
      const int k = base + lane;
      const int v = k < bucket ? cursor[k] : 0;
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      if (k < bucket) {
        start[k] = carry + incl - v;
        cursor[k] = carry + incl - v;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) start[bucket] = carry;
  }
  __syncthreads();

  // stable placement: warp 0 walks the centres in order, 32 at a time;
  // lanes with the same target get consecutive slots by lane rank
  if (tid < 32) {
    const unsigned lt = (1u << lane) - 1u;
    for (int base = 0; base < m; base += 32) {
      const int i = base + lane;
      const int k = i < m ? target[i] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, k);
      int pos = 0;
      if (k >= 0) pos = cursor[k] + __popc(same & lt);
      __syncwarp();
      if (k >= 0) {
        list[pos] = tag[i];
        if ((same & lt) == 0) cursor[k] += __popc(same);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // one thread per (point, channel of the slice): sum the point's list
  // in order
  const int total = len * width;
  for (int e = tid; e < total; e += kThreads) {
    const int k = e / width;
    const int ch = c0 + (e - k * width);
    float acc = 0.f;
    for (int j = start[k]; j < start[k + 1]; ++j) {
      const int entry = list[j];
      const long long row = (long long)b * m + (entry & kIndexMask);
      if (entry & kHitBit) acc += gout[(row * nsample + t) * c + ch];
      if (entry & kFirstBit) acc += fold[row * c + ch];
    }
    grad[((long long)b * n + lo + k) * c + ch] = acc;
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // 16 blocks per SM, grid-stride after
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

// the forward with c counted in elements of T
template <typename T>
int launch_fwd(const float* points, const int* idx, int b, int n, int m,
               int nsample, int c, float* out, cudaStream_t st) {
  const long long total = (long long)b * m * nsample * c;
  const int grid = grid_for(total);
  const T* pts = reinterpret_cast<const T*>(points);
  T* dst = reinterpret_cast<T*>(out);
  if (total < kInt32Limit && (long long)b * n * c < kInt32Limit)
    group_fwd_kernel<T, int><<<grid, kThreads, 0, st>>>(
        pts, idx, m * nsample, n, c, (int)total, dst);
  else
    group_fwd_kernel<T, long long><<<grid, kThreads, 0, st>>>(
        pts, idx, (long long)m * nsample, n, c, total, dst);
  return (int)cudaGetLastError();
}

// shared memory of the reduce pass for m centres and this bucket
long long reduce_smem_bytes(int m, int bucket) {
  return (3LL * m + 2LL * bucket + 1) * (long long)sizeof(int);
}

}  // namespace

extern "C" {

// points (b, n, c) f32 contiguous; idx (b, m, nsample) int32 contiguous,
// each in [0, n); out (b, m, nsample, c) f32. Returns the cudaError_t of
// the launch.
int group_stratified_fwd_launch(const float* points, const int* idx,
                                int b, int n, int m, int nsample, int c,
                                float* out, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || nsample <= 0 || c <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t base = reinterpret_cast<uintptr_t>(points) |
                         reinterpret_cast<uintptr_t>(out);
  if (c % 4 == 0 && base % 16 == 0)
    return launch_fwd<float4>(points, idx, b, n, m, nsample, c / 4, out,
                              st);
  return launch_fwd<float>(points, idx, b, n, m, nsample, c, out, st);
}

// gout (b, m, nsample, c) f32, idx (b, m, nsample) int32, hit (b, m,
// nsample) bool, all contiguous; fold (b, m, c) f32 and first (b, m)
// int32 are scratch; grad (b, n, c) f32 is written in full. Launches the
// fold pass and then the reduce pass on `stream`; returns the first
// nonzero cudaError_t.
int group_stratified_bwd_launch(const float* gout, const int* idx,
                                const unsigned char* hit, int b, int n,
                                int m, int nsample, int bucket, int c,
                                float* fold, int* first, float* grad,
                                void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || nsample <= 0 || c <= 0 ||
      (long long)bucket * nsample < n || m > kFirstBit - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)b * m;
  group_bwd_fold_kernel<<<grid_for(rows * c), kThreads, 0, st>>>(
      gout, hit, rows, nsample, c, fold, first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long smem = reduce_smem_bytes(m, bucket);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(group_bwd_reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(nsample, b, (c + kChunk - 1) / kChunk);
  group_bwd_reduce_kernel<<<grid, kThreads, smem, st>>>(
      gout, fold, idx, hit, first, n, m, nsample, bucket, c, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
