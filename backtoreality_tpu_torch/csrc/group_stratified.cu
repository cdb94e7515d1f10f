// Stratified grouping for Hopper (sm_90a), forward and backward, plain C
// interface.
//
// Replaces the Pallas TPU kernel `_group_bucketed_kernel` in
// backtoreality_tpu/ops/grouping.py (launched by `_group_bucketed_pallas`,
// with its custom VJP and the first-hit repair of
// `group_points_stratified`), and, in its fused entry, the localize step
// that the set-abstraction layer runs around it
// (backtoreality_tpu/nn/sa_fp.py, `_group`): the centre subtracted from the
// grouped coordinates, the division by the radius and the concatenation
// with the grouped features.
//
// Forward, two entries into one kernel (`group_rows_kernel`):
//   group:    out[b, m, s, :] = points[b, idx[b, m, s], :], any width C;
//   localize: out[b, m, s, 0:3] = (xyz[b, idx] - centre[b, m]) / radius,
//             out[b, m, s, 3:]  = features[b, idx]  (features may be absent).
// The TPU kernel builds a one-hot per stratum and reduces it against the
// stratum's points (a matrix-unit form of a gather), and then repairs the
// slot-filled entries from the first-hit slot; the result is this gather,
// which a GPU does directly. The copy equals the plain version bit for
// bit, and so do the three local coordinates: one IEEE subtraction and one
// IEEE division each, in that order.
//
// What bounds the forward: bytes, and of those the output's (B*M*S*C
// floats written once; the point rows are picked by many centres and come
// from L2). The first version gave every element a thread, which divided
// by the channel count, read the row's index again and then its value, a
// dependent chain, and it took float4s only where C % 4 == 0: never in the
// model past the first layer, whose rows are xyz and features side by
// side, 131 or 259 floats. And the layer then read and wrote the whole
// output again to localize it, after a pass that put xyz and features
// side by side for the gather. Now a group of lanes owns an output row: a
// warp, or 8 or 16 lanes where the row is narrower, and one thread where
// it is 4 floats or fewer (the first layer, `group_narrow_kernel`: its
// loads together, one 16-byte store). A block owns a centre (b, m), so no
// thread divides; a
// group reads its row's index once and copies the row with consecutive
// lanes on consecutive addresses, up to 8 loads in flight before the
// first store. The fused entry reads xyz and features as two inputs (no
// concatenation before it, none after it) and computes the three local
// coordinates in the lanes that copy them. Stores are 4 bytes a lane,
// coalesced: an output row of 131 or 259 floats starts at any 4-byte
// offset, so a 16-byte store would need the row's values shifted across
// lanes; consecutive lanes on consecutive words fill every 32-byte sector
// but a row's first and last, and L2 merges those with the neighbouring
// rows' before they reach device memory. The loads are 4 bytes a lane for
// the same reason (the output word a lane stores is the input word it
// loaded, shifted by the three coordinates), and come from L1 and L2.
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
// The backward of the fused entry is the same three passes, unchanged, over
// the whole grad_out row (3 + C channels), so no elementwise pass runs over
// grad_out before them; the result's channels 3 and on are the gradient of
// the features. Where xyz needs a gradient (vote clustering), the sums of
// the first three channels are multiplied by 1 / radius in place, and where
// the centres need one, -(1 / radius) times the sum over a centre's slots of
// those three channels is taken in slot order: both by one small kernel,
// `group_localize_tail_kernel`, launched only when either is asked for.
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
// What bounds the backward: bytes (one add per gradient element); it reads
// grad_out, idx and hit once and writes B*N*C floats. The first version
// rebuilt the lists in every 32-channel block (5 to 9 times per stratum),
// on one warp, and left a third to three quarters of its blocks without a
// live stratum; the lists are now built once, by all warps, and the passes
// that move the bytes are flat grids of independent warps. What keeps the
// reduce from its bound is latency, not bytes: a group's segment, entries
// and rows are three dependent trips to memory, and the longest list of a
// stratum is a chain of rounds on one warp per slice.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCopyInFlight = 8;  // loads of a row before its first store

// Forward for rows wider than 4 floats: a group of G lanes per output row
// (b, m, s), a block per centre (b, m). The row is `hw` head channels (0,
// or the 3 coordinates of `head` (b, n, 3), localized when kLocal: centre
// (b, m, 3) subtracted, divided by the radius) followed by the `c`
// channels of `feats` (b, n, c).
template <int G, bool kLocal>
__global__ void __launch_bounds__(kThreads)
    group_rows_kernel(const float* __restrict__ head,
                      const float* __restrict__ feats,
                      const float* __restrict__ centre,
                      const int* __restrict__ idx, int n, int m, int nsample,
                      int hw, int c, float radius, float* __restrict__ out) {
  const int b = blockIdx.y;
  const long long bm = (long long)b * m + blockIdx.x;
  const int lane = threadIdx.x % G;
  const int width = hw + c;
  float cv = 0.f;  // hw <= G: a head channel is always its lane's first
  if (kLocal && lane < hw) cv = __ldg(centre + bm * 3 + lane);
  for (int s = threadIdx.x / G; s < nsample; s += kThreads / G) {
    const long long row = bm * nsample + s;
    const long long src = (long long)b * n + __ldg(idx + row);
    const float* h = head + src * hw;
    const float* f = feats + src * c;
    float* o = out + row * width;
    for (int ch0 = lane; ch0 < width; ch0 += G * kCopyInFlight) {
      float v[kCopyInFlight];
#pragma unroll
      for (int u = 0; u < kCopyInFlight; ++u) {
        const int ch = ch0 + u * G;
        if (ch < hw) {
          v[u] = __ldg(h + ch);
          if (kLocal) v[u] = __fdiv_rn(__fsub_rn(v[u], cv), radius);
        } else if (ch < width) {
          v[u] = __ldg(f + (ch - hw));
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyInFlight; ++u)
        if (ch0 + u * G < width) o[ch0 + u * G] = v[u];
    }
  }
}

// Forward for rows of up to 4 floats (the first layer: xyz and a height):
// a thread per row, its loads in flight together and one 16-byte store
// where the row is 4 floats (`vec_out`; `vec_in` where it is also read as
// one, the unfused entry). threadIdx.x walks a centre's slots and
// threadIdx.y the block's centres, so no thread divides.
template <bool kLocal>
__global__ void __launch_bounds__(kThreads)
    group_narrow_kernel(const float* __restrict__ head,
                        const float* __restrict__ feats,
                        const float* __restrict__ centre,
                        const int* __restrict__ idx, int n, int m,
                        int nsample, int hw, int c, float radius,
                        bool vec_in, bool vec_out, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int mi = blockIdx.x * blockDim.y + threadIdx.y;
  if (mi >= m) return;
  const long long bm = (long long)b * m + mi;
  const int width = hw + c;
  float cv[3] = {0.f, 0.f, 0.f};
  if (kLocal) {  // hw == 3
#pragma unroll
    for (int k = 0; k < 3; ++k) cv[k] = __ldg(centre + bm * 3 + k);
  }
  for (int s = threadIdx.x; s < nsample; s += blockDim.x) {
    const long long row = bm * nsample + s;
    const long long src = (long long)b * n + __ldg(idx + row);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec_in) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(feats) + src);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        if (ch < width)
          v[ch] = ch < hw ? __ldg(head + src * hw + ch)
                          : __ldg(feats + src * c + (ch - hw));
    }
    if (kLocal) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[k] = __fdiv_rn(__fsub_rn(v[k], cv[k]), radius);
    }
    if (vec_out) {
      reinterpret_cast<float4*>(out)[row] =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        if (ch < width) out[row * width + ch] = v[ch];
    }
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
// at the first layer) 16, 8 or 4 lanes. A round reads kEntries entries of
// each point, then their rows:
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

// What the fused entry's backward adds to the three passes, one small
// kernel over two ranges of threads. The first `heads` = b * n * 3 threads
// (0 when xyz needs no gradient) multiply grad[b, n, 0:3], the sums of
// grad_out's three coordinate channels, by `scale` = 1 / radius in place:
// the factor once on each sum, where a product on every row read kept the
// reduce's loads from going out together. The next `centres` = b * m * 3
// threads (0 when the centres need no gradient) write gcentre[b, m, k] =
// -scale * sum over s, in slot order, of gout[b, m, s, k].
__global__ void __launch_bounds__(kThreads)
    group_localize_tail_kernel(const float* __restrict__ gout,
                               long long heads, long long centres,
                               int nsample, int c, float scale,
                               float* __restrict__ grad,
                               float* __restrict__ gcentre) {
  long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < heads) {
    const long long row = t / 3;
    grad[row * c + (t - row * 3)] *= scale;
    return;
  }
  t -= heads;
  if (t >= centres) return;
  const long long row = t / 3;
  const float* g = gout + row * nsample * c + (t - row * 3);
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsample; ++s) acc += __ldg(g + (long long)s * c);
  gcentre[t] = -(scale * acc);
}

// the forward of both entries: a block per centre, a group of lanes per row
int launch_rows(const float* head, const float* feats, const float* centre,
                const int* idx, int b, int n, int m, int nsample, int hw,
                int c, float radius, float* out, cudaStream_t st) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || nsample <= 0 || c < 0 ||
      hw + c <= 0)
    return (int)cudaErrorInvalidValue;
  const int width = hw + c;
  const bool local = centre != nullptr;
  if (width <= 4) {
    const bool vec_out =
        width == 4 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const bool vec_in =
        vec_out && hw == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
    const int slots = nsample < kThreads ? nsample : kThreads;
    const dim3 block(slots, kThreads / slots);
    const dim3 grid((m + block.y - 1) / block.y, b);
    if (local)
      group_narrow_kernel<true><<<grid, block, 0, st>>>(
          head, feats, centre, idx, n, m, nsample, hw, c, radius, vec_in,
          vec_out, out);
    else
      group_narrow_kernel<false><<<grid, block, 0, st>>>(
          head, feats, centre, idx, n, m, nsample, hw, c, radius, vec_in,
          vec_out, out);
    return (int)cudaGetLastError();
  }
  const int lanes = width > 16 ? 32 : width > 8 ? 16 : 8;
  decltype(&group_rows_kernel<32, true>) kernel =
      lanes == 32   ? (local ? &group_rows_kernel<32, true>
                             : &group_rows_kernel<32, false>)
      : lanes == 16 ? (local ? &group_rows_kernel<16, true>
                             : &group_rows_kernel<16, false>)
                    : (local ? &group_rows_kernel<8, true>
                             : &group_rows_kernel<8, false>);
  kernel<<<dim3(m, b), kThreads, 0, st>>>(head, feats, centre, idx, n, m,
                                          nsample, hw, c, radius, out);
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

// the three passes of the backward
int launch_bwd(const float* gout, const int* idx, const unsigned char* hit,
               int b, int n, int m, int nsample, int bucket, int c,
               int* start, int* list, float* fold, float* grad,
               cudaStream_t st) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || nsample <= 0 || c <= 0 ||
      bucket <= 0 || bucket % kPoints != 0 ||
      (long long)bucket * nsample < n || m > kOffsetMask ||
      bucket > kOffsetMask)
    return (int)cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// points (b, n, c) f32 contiguous; idx (b, m, nsample) int32 contiguous,
// each in [0, n); out (b, m, nsample, c) f32. Returns the cudaError_t of
// the launch.
int group_stratified_fwd_launch(const float* points, const int* idx,
                                int b, int n, int m, int nsample, int c,
                                float* out, void* stream) {
  return launch_rows(nullptr, points, nullptr, idx, b, n, m, nsample, 0, c,
                     1.f, out, static_cast<cudaStream_t>(stream));
}

// The fused entry. xyz (b, n, 3), features (b, n, c) or null with c == 0,
// new_xyz (b, m, 3), all f32 contiguous; idx as above; out (b, m, nsample,
// 3 + c): channels 0-2 (xyz[b, idx] - new_xyz[b, m]) / radius, the rest
// features[b, idx]. Returns the cudaError_t of the launch.
int group_localize_fwd_launch(const float* xyz, const float* features,
                              const float* new_xyz, const int* idx, int b,
                              int n, int m, int nsample, int c, float radius,
                              float* out, void* stream) {
  if (xyz == nullptr || new_xyz == nullptr || (c > 0 && features == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_rows(xyz, features, new_xyz, idx, b, n, m, nsample, 3, c,
                     radius, out, static_cast<cudaStream_t>(stream));
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
  return launch_bwd(gout, idx, hit, b, n, m, nsample, bucket, c, start, list,
                    fold, grad, static_cast<cudaStream_t>(stream));
}

// The backward of the fused entry: as above over the c = 3 + C channels of
// gout, so that grad[..., 3:] is the gradient of the features; with
// `scale_xyz`, grad[..., 0:3] is multiplied by `inv_radius` and is the
// gradient of xyz (without it those three channels are sums nobody reads).
// gcentre (b, m, 3), if not null, receives the gradient of new_xyz.
int group_localize_bwd_launch(const float* gout, const int* idx,
                              const unsigned char* hit, int b, int n, int m,
                              int nsample, int bucket, int c,
                              float inv_radius, int* start, int* list,
                              float* fold, float* grad, int scale_xyz,
                              float* gcentre, void* stream) {
  if (c < 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_bwd(gout, idx, hit, b, n, m, nsample, bucket, c,
                             start, list, fold, grad, st);
  const long long heads = scale_xyz ? (long long)b * n * 3 : 0;
  const long long centres = gcentre != nullptr ? (long long)b * m * 3 : 0;
  if (err != 0 || heads + centres == 0) return err;
  const long long blocks = (heads + centres + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  group_localize_tail_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      gout, heads, centres, nsample, c, inv_radius, grad, gcentre);
  return (int)cudaGetLastError();
}

}  // extern "C"
