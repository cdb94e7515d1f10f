// Stratified ball query for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_bq_stratified_kernel` in
// backtoreality_tpu/ops/ball_query.py, together with the slot-fill and
// the clamp to n-1 that its wrapper runs in XLA afterwards.
//
// Semantics (those of `_ball_query_stratified_torch` in
// ops/ball_query.py): the N points are split into `nsample` contiguous
// buckets of `bucket` indices (bucket * nsample >= N; indices >= N are
// padding and never hit). For each centre c, slot s takes the first
// point of bucket s with |c - p|^2 < r^2 and reports a hit; an empty slot
// takes the first hit of the first non-empty bucket (index 0 if the
// centre has no hit at all); every index is clamped to n-1.
//
// The radius test is computed directly as a sum of squared differences
// in f32, not through the TPU kernel's bf16 hi/lo compensated matrix
// product (a device for the TPU's matrix unit). It can disagree with the
// plain version's expanded form |c|^2 - 2 c.p + |p|^2 only for points
// whose squared distance lies within rounding error (about 1e-5) of r^2.
//
// What bounds it: the scans. A slot's scan stops at its bucket's first
// hit, so the work depends on the data; a sparse neighbourhood (SA1:
// r=0.2 in a room) scans most buckets to their end, about B*M*N distance
// tests of 9 flops. The points of one batch row (N*12 bytes) stay in L1
// and L2 and are read far more often than device memory is touched.
//
// Design: a block owns 32 centres of one batch row; lane l of every warp
// holds centre l in registers, and warp w scans buckets w, w+8, ... So
// all 32 lanes of a warp read the same point at the same time (one
// broadcast load), each lane stops at its own first hit, and nothing but
// the per-slot first-hit offsets is shared. After one barrier the block
// resolves the slot-fill in shared memory and writes idx and hit for its
// 32 x nsample tile with consecutive threads on consecutive addresses.

#include <cuda_runtime.h>

namespace {

constexpr int kCentres = 32;  // centres per block: one per lane
constexpr int kWarps = 8;     // warps per block, each over its own buckets
constexpr int kMaxSlots = 64;

__global__ void __launch_bounds__(kCentres * kWarps)
    bq_stratified_kernel(const float* __restrict__ xyz, long long xsb,
                         long long xsn, const float* __restrict__ ctr,
                         long long csb, long long csn, int n, int m,
                         float r2, int nsample, int bucket,
                         int* __restrict__ idx_out,
                         unsigned char* __restrict__ hit_out) {
  // first hit offset within its bucket, or -1; +1 column avoids bank
  // conflicts between lanes
  __shared__ int first[kCentres][kMaxSlots + 1];
  __shared__ int fill[kCentres];

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kCentres;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = m0 + lane;
  const bool live = c < m;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (live) {
    const float* q = ctr + b * csb + c * csn;
    cx = q[0];
    cy = q[1];
    cz = q[2];
  }
  const float* row = xyz + b * xsb;

  for (int s = warp; s < nsample; s += kWarps) {
    const int start = s * bucket;
    const int len = min(bucket, n - start);  // <= 0: bucket is all padding
    int found = -1;
    if (live) {
      for (int j = 0; j < len; ++j) {
        const float* p = row + (start + j) * xsn;
        float dx = cx - __ldg(p);
        float dy = cy - __ldg(p + 1);
        float dz = cz - __ldg(p + 2);
        if (dx * dx + dy * dy + dz * dz < r2) {
          found = j;
          break;
        }
      }
    }
    first[lane][s] = found;
  }
  __syncthreads();

  if (warp == 0) {
    int f = 0;  // no hit anywhere: every slot is index 0
    for (int s = 0; s < nsample; ++s) {
      if (first[lane][s] >= 0) {
        f = s * bucket + first[lane][s];
        break;
      }
    }
    fill[lane] = f;
  }
  __syncthreads();

  const int tile = kCentres * nsample;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int cl = e / nsample;
    const int s = e - cl * nsample;
    if (m0 + cl >= m) break;  // e only grows: the rest is past M too
    const int loc = first[cl][s];
    const bool hit = loc >= 0;
    const int v = min(hit ? s * bucket + loc : fill[cl], n - 1);
    const long long o = ((long long)b * m + m0 + cl) * nsample + s;
    idx_out[o] = v;
    hit_out[o] = hit ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// xyz: row b, point i, coordinate k at xyz[b*xsb + i*xsn + k] (float32);
// centres likewise with (csb, csn). idx (b, m, nsample) int32 and hit
// (b, m, nsample) bool, both contiguous. Returns the cudaError_t of the
// launch (0 on success).
int bq_stratified_launch(const float* xyz, long long xsb, long long xsn,
                         const float* ctr, long long csb, long long csn,
                         int b, int n, int m, float r2, int nsample,
                         int bucket, int* idx, unsigned char* hit,
                         void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || nsample <= 0 || nsample > kMaxSlots ||
      (long long)bucket * nsample < n)
    return (int)cudaErrorInvalidValue;
  dim3 grid((m + kCentres - 1) / kCentres, b);
  bq_stratified_kernel<<<grid, kCentres * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      xyz, xsb, xsn, ctr, csb, csn, n, m, r2, nsample, bucket, idx, hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
