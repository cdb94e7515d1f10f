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
// (the one-hot contraction per stratum plus the repair's transpose). A
// centre m feeds the point idx[b, m, t] of stratum t through slot t when
// that slot is a hit, and through all its slot-filled slots (hit == false,
// which hold the index of its first hit) when t is its first-hit slot
// (slot 0 for a centre with no hit). Three passes:
//
//   1. lists (one block per (b, live stratum t), integers only): every
//      centre's slot t is classified (a hit adds the centre's grad_out row
//      at slot t, a first hit its fold row), the entries per point of the
//      stratum are counted, a block scan gives each point its segment, the
//      entries are dropped into their segments and then put in order by
//      rank (an entry counts the smaller keys of its own segment):
//      increasing m, a centre's grad_out row before its fold row. The
//      result is a CSR per (b, t): `start` (bucket + 1 offsets) and `list`
//      (entries m, with kFoldBit for a fold row), written once per call,
//      whatever the number of channels. All loads of a centre are started
//      together. Strata past n hold no point and get no block.
//   2. fold (one warp per (b, m, channel slice)): the gradients of the
//      centre's slot-filled slots are summed in slot order into
//      fold[b, m, :]. The warp reads the hit row once (a ballot), then
//      walks the filled slots eight loads at a time.
//   3. reduce (a flat grid, one group of lanes per (b, 4 points, channel
//      slice)): the group reads its points' segments and sums each in list
//      order, an entry being one row of grad_out or of fold. A round reads
//      4 entries of each point, then their 16 rows, so 16 loads are in
//      flight though most lists hold a few entries. A large radius sends
//      most centres to the first few points of a stratum; a group that
//      meets such a list (more than 8 entries) sums its points one after
//      the other, 16 entries of one list a round. Every point is written,
//      zero where nothing lands. No shared memory, no block barrier: the
//      hardware balances points with long lists against points with none.
//
// The channels are cut into ceil(C / 32) slices of equal width, a lane
// each: C = 131 is 5 slices of 27, and no slice is left with 3 channels. A
// slice of 16 channels or fewer takes 16, 8 or 4 lanes in the reduce, so a
// warp serves several groups (C = 4 at the first layer).
//
// The only place a point outside stratum t could show up in slot t is a
// filled slot, which pass 1 never lists; the one exception is slot 0 of a
// centre with no hit (index 0, in stratum 0), which is listed as a first
// and never as a hit. Precondition: idx and hit come from the stratified
// ball query (slot-filled with the first hit, index 0 for a centre with no
// hit); bucket * nsample >= n.
//
// What bounds it: bytes. Both directions do no arithmetic worth counting
// (one add per gradient element); the forward reads idx and writes
// B*M*S*C floats, the backward reads grad_out, idx and hit once and writes
// B*N*C floats. The forward's point rows are re-read through L1/L2 (the
// same points are picked by many centres). The first version of the
// backward rebuilt the lists in every 32-channel block (5 to 9 times per
// stratum), on one warp, and left a third to three quarters of its blocks
// without a live stratum; the lists are now built once, by all warps, and
// the passes that move the bytes are flat grids of independent warps.
// What keeps the reduce from its bound is latency, not bytes: a group's
// segment, entries and rows are three dependent trips to memory, and the
// longest list of a stratum is a chain of rounds on one warp per slice.
// Index math is 32-bit in the forward where every offset fits (all of the
// model's shapes), 64-bit otherwise and in the backward; the forward moves
// a float4 per thread when C % 4 == 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
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

// A list entry is the centre whose row it adds: its grad_out row at slot t,
// or with kFoldBit its fold row.
constexpr int kFoldBit = 1 << 30;
constexpr int kIndexMask = kFoldBit - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kListThreads = 512;
constexpr int kListWarps = kListThreads / 32;
// in the lists pass, a centre's target: offset in the stratum | flags
constexpr int kIsHit = 1 << 30;
constexpr int kIsFirst = 1 << 29;
constexpr int kOffsetMask = kIsFirst - 1;

// The first set slot of a hit row, or -1. `wide` when the row may be read
// 16 bytes at a time (nsample % 16 == 0 and the array 16-byte aligned).
__device__ __forceinline__ int first_slot(const unsigned char* __restrict__ h,
                                          int nsample, bool wide) {
  int first = -1;
  if (wide) {
    const uint4* q = reinterpret_cast<const uint4*>(h);
#pragma unroll 4
    for (int i = 0; i < nsample / 16; ++i) {
      const uint4 v = __ldg(q + i);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)  // a set byte is 1: bit 8 * byte
        if (w[j] != 0 && first < 0)
          first = 16 * i + 4 * j + ((__ffs(w[j]) - 1) >> 3);
    }
  } else {
    for (int s = 0; s < nsample; ++s)
      if (h[s] != 0 && first < 0) first = s;
  }
  return first;
}

// pass 1: the contributions to each point of stratum t, as a CSR
__global__ void __launch_bounds__(kListThreads)
    group_bwd_lists_kernel(const int* __restrict__ idx,
                           const unsigned char* __restrict__ hit, int n,
                           int m, int nsample, int bucket,
                           int* __restrict__ start, int* __restrict__ list) {
  extern __shared__ int smem[];
  __shared__ int warp_sum[kListWarps];
  int* target = smem;              // m: offset in the stratum | flags, or -1
  int* unsorted = target + m;      // 2 m: entry keys, grouped by point
  int* seg = unsorted + 2 * m;     // bucket + 1: segment starts
  int* cursor = seg + bucket + 1;  // bucket: counts, then cursors

  const int t = blockIdx.x;  // a live stratum: t * bucket < n
  const int b = blockIdx.y;
  const int lo = t * bucket;
  const int len = min(bucket, n - lo);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool wide =
      nsample % 16 == 0 && reinterpret_cast<uintptr_t>(hit) % 16 == 0;

  for (int k = tid; k < bucket; k += kListThreads) cursor[k] = 0;
  __syncthreads();

  // which point of this stratum each centre's slot t feeds, and how: its
  // grad_out row if the slot is a hit, its fold row if the slot is its
  // first hit (slot 0 for a centre with no hit at all). The loads do not
  // depend on one another, so they are one trip to memory.
  for (int i = tid; i < m; i += kListThreads) {
    const long long row = (long long)b * m + i;
    const unsigned char* h = hit + row * nsample;
    const int k = __ldg(idx + row * nsample + t) - lo;
    const bool is_hit = h[t] != 0;
    const int first = first_slot(h, nsample, wide);
    const bool is_first = first == t || (first < 0 && t == 0);
    int tagged = -1;
    // a target outside the stratum is outside the precondition: skipped
    if ((is_hit || is_first) && k >= 0 && k < len) {
      tagged = k | (is_hit ? kIsHit : 0) | (is_first ? kIsFirst : 0);
      atomicAdd(&cursor[k], (int)is_hit + (int)is_first);  // exact
    }
    target[i] = tagged;
  }
  __syncthreads();

  // exclusive scan of the counts, kListThreads at a time
  int carry = 0;
  for (int k0 = 0; k0 < bucket; k0 += kListThreads) {
    const int k = k0 + tid;
    const int v = k < bucket ? cursor[k] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kListWarps; ++w) {
      if (w < warp) before += warp_sum[w];
      total += warp_sum[w];
    }
    if (k < bucket) {
      seg[k] = carry + before + incl - v;
      cursor[k] = seg[k];
    }
    carry += total;
    __syncthreads();
  }
  if (tid == 0) seg[bucket] = carry;
  __syncthreads();

  // drop every entry's key (2 * centre, + 1 for the fold row) into its
  // point's segment, in any order ...
  for (int i = tid; i < m; i += kListThreads) {
    const int tagged = target[i];
    if (tagged < 0) continue;
    const int k = tagged & kOffsetMask;
    if (tagged & kIsHit) unsorted[atomicAdd(&cursor[k], 1)] = 2 * i;
    if (tagged & kIsFirst) unsorted[atomicAdd(&cursor[k], 1)] = 2 * i + 1;
  }
  __syncthreads();

  // ... then place it by the rank of its key in the segment: increasing
  // centre, a centre's grad_out row before its fold row
  const long long cell = (long long)b * gridDim.x + t;
  int* out_list = list + cell * 2 * m;
  for (int i = tid; i < m; i += kListThreads) {
    const int tagged = target[i];
    if (tagged < 0) continue;
    const int k = tagged & kOffsetMask;
    int below = 0, has = 0;  // keys below 2 i, and whether 2 i is there
    for (int j = seg[k]; j < seg[k + 1]; ++j) {
      below += unsorted[j] < 2 * i;
      has += unsorted[j] == 2 * i;
    }
    if (tagged & kIsHit) out_list[seg[k] + below] = i;
    if (tagged & kIsFirst) out_list[seg[k] + below + has] = i | kFoldBit;
  }
  int* out_start = start + cell * (bucket + 1);
  for (int k = tid; k <= bucket; k += kListThreads) out_start[k] = seg[k];
}

constexpr int kInFlight = 8;  // rows loaded before their sums are taken

// pass 2: fold[b, m, :] = the centre's slot-filled gradients, in slot
// order; one warp per (row, slice of `width` channels)
__global__ void __launch_bounds__(kThreads)
    group_bwd_fold_kernel(const float* __restrict__ gout,
                          const unsigned char* __restrict__ hit,
                          long long rows, int nsample, int c, int nslices,
                          int width, float* __restrict__ fold) {
  const long long w =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= rows * nslices) return;
  const int lane = threadIdx.x & 31;
  const long long row = w / nslices;
  const int ch = (int)(w - row * nslices) * width + lane;
  const bool ok = lane < width && ch < c;
  const unsigned char* h = hit + row * nsample;
  const float* g = gout + row * nsample * c + ch;
  float acc = 0.f;
  for (int s0 = 0; s0 < nsample; s0 += 32) {
    const bool filled = s0 + lane < nsample && h[s0 + lane] == 0;
    unsigned todo = __ballot_sync(kFull, filled);
    while (todo) {
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const bool live = ok && todo != 0;
        const int s = s0 + __ffs(todo) - 1;
        v[u] = live ? __ldg(g + (long long)s * c) : 0.f;
        todo &= todo - 1;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) acc += v[u];
    }
  }
  if (ok) fold[row * c + ch] = acc;
}

constexpr int kPoints = 4;   // points per warp in the reduce
constexpr int kEntries = 4;  // entries read per point and round
constexpr int kRound = kPoints * kEntries;  // loads in flight

// The rows of R entries (-1: none) of one lane's channel.
template <int R>
__device__ __forceinline__ void read_rows(const int (&entry)[R],
                                          const float* __restrict__ g,
                                          long long g_row,
                                          const float* __restrict__ f, int c,
                                          bool ok, float (&val)[R]) {
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const int centre = entry[v] & kIndexMask;
    const float* src = (entry[v] & kFoldBit) ? f + (long long)centre * c
                                             : g + centre * g_row;
    val[v] = ok && entry[v] >= 0 ? __ldg(src) : 0.f;
  }
}

// pass 3: per (b, kPoints points, slice), the ordered sum of each point's
// list, by a group of G lanes: a warp, or where the slice is narrow (C = 4
// at the first layer) 16, 8 or 4 lanes. A round reads kEntries entries of each point, then their rows:
// kRound loads in flight while the lists are short, as most are. A large
// radius sends most centres to a stratum's first few points, whose lists
// run to a hundred and more; a warp that holds such a list sums its
// points one after the other, kRound entries of one list a round.
template <int G>
__global__ void __launch_bounds__(kThreads, 4)
    group_bwd_reduce_kernel(const float* __restrict__ gout,
                            const float* __restrict__ fold,
                            const int* __restrict__ start,
                            const int* __restrict__ list, long long groups,
                            int n, int m, int nsample, int bucket, int live,
                            int c, int nslices, int width,
                            float* __restrict__ grad) {
  const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (w >= groups) return;
  const int lane = threadIdx.x % G;
  const long long quad = w / nslices;  // (b, p0 / kPoints) flattened
  const int ch = (int)(w - quad * nslices) * width + lane;
  const bool ok = lane < width && ch < c;
  const int quads = (n + kPoints - 1) / kPoints;
  const int b = (int)(quad / quads);
  const int p0 = (int)(quad - (long long)b * quads) * kPoints;
  // bucket % kPoints == 0: the points share a stratum
  const int t = p0 / bucket;
  const long long cell = (long long)b * live + t;
  const int* seg = start + cell * (bucket + 1) + (p0 - t * bucket);
  const int* entries = list + cell * 2 * m;
  int from[kPoints + 1], longest = 0;
#pragma unroll
  for (int u = 0; u <= kPoints; ++u) from[u] = __ldg(seg + u);
#pragma unroll
  for (int u = 0; u < kPoints; ++u)
    longest = max(longest, from[u + 1] - from[u]);
  const float* g = gout + ((long long)b * m * nsample + t) * c + ch;
  const float* f = fold + (long long)b * m * c + ch;
  const long long g_row = (long long)nsample * c;
  float acc[kPoints] = {};
  int entry[kRound];
  float val[kRound];
  if (longest <= 2 * kEntries) {
    for (int r = 0; r < longest; r += kEntries) {
#pragma unroll
      for (int u = 0; u < kPoints; ++u)
#pragma unroll
        for (int v = 0; v < kEntries; ++v) {
          const int j = from[u] + r + v;
          entry[u * kEntries + v] =
              j < from[u + 1] ? __ldg(entries + j) : -1;
        }
      read_rows(entry, g, g_row, f, c, ok, val);
#pragma unroll
      for (int u = 0; u < kPoints; ++u)
#pragma unroll
        for (int v = 0; v < kEntries; ++v) acc[u] += val[u * kEntries + v];
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPoints; ++u)
      for (int j0 = from[u]; j0 < from[u + 1]; j0 += kRound) {
#pragma unroll
        for (int v = 0; v < kRound; ++v)
          entry[v] = j0 + v < from[u + 1] ? __ldg(entries + j0 + v) : -1;
        read_rows(entry, g, g_row, f, c, ok, val);
#pragma unroll
        for (int v = 0; v < kRound; ++v) acc[u] += val[v];
      }
  }
#pragma unroll
  for (int u = 0; u < kPoints; ++u)
    if (ok && p0 + u < n) grad[((long long)b * n + p0 + u) * c + ch] = acc[u];
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

// shared memory of the lists pass for m centres and this bucket
long long lists_smem_bytes(int m, int bucket) {
  return (3LL * m + 2LL * bucket + 1) * (long long)sizeof(int);
}

// blocks of kWarps warps for this many warps, or 0 if a grid cannot hold
// them
long long warp_blocks(long long warps) {
  const long long blocks = (warps + kWarps - 1) / kWarps;
  return blocks < (1LL << 31) ? blocks : 0;
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
// nsample) bool, all contiguous. Scratch: start (b, live, bucket + 1) and
// list (b, live, 2 m) int32, with live = ceil(n / bucket) strata, and fold
// (b, m, c) f32. grad (b, n, c) f32 is written in full. Launches the
// three passes on `stream`; returns the first nonzero cudaError_t.
int group_stratified_bwd_launch(const float* gout, const int* idx,
                                const unsigned char* hit, int b, int n,
                                int m, int nsample, int bucket, int c,
                                int* start, int* list, float* fold,
                                float* grad, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || nsample <= 0 || c <= 0 ||
      bucket <= 0 || bucket % kPoints != 0 ||
      (long long)bucket * nsample < n || m > kOffsetMask ||
      bucket > kOffsetMask)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int live = (n + bucket - 1) / bucket;
  // slices of equal width: C = 131 is 5 slices of 27 channels
  const int nslices = (c + 31) / 32;
  const int width = (c + nslices - 1) / nslices;
  const long long rows = (long long)b * m;
  const long long quads =
      (long long)b * ((n + kPoints - 1) / kPoints) * nslices;
  const int lanes = width > 16 ? 32 : width > 8 ? 16 : width > 4 ? 8 : 4;
  const long long fold_blocks = warp_blocks(rows * nslices);
  const long long reduce_blocks = warp_blocks((quads * lanes + 31) / 32);
  if (fold_blocks == 0 || reduce_blocks == 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = lists_smem_bytes(m, bucket);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(group_bwd_lists_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  group_bwd_lists_kernel<<<dim3(live, b), kListThreads, smem, st>>>(
      idx, hit, n, m, nsample, bucket, start, list);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_bwd_fold_kernel<<<(unsigned)fold_blocks, kThreads, 0, st>>>(
      gout, hit, rows, nsample, c, nslices, width, fold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decltype(&group_bwd_reduce_kernel<32>) reduce =
      lanes == 32   ? &group_bwd_reduce_kernel<32>
      : lanes == 16 ? &group_bwd_reduce_kernel<16>
      : lanes == 8  ? &group_bwd_reduce_kernel<8>
                    : &group_bwd_reduce_kernel<4>;
  reduce<<<(unsigned)reduce_blocks, kThreads, 0, st>>>(
      gout, fold, start, list, quads, n, m, nsample, bucket, live, c,
      nslices, width, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
