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
// The radius test is computed in f32, not through the TPU kernel's bf16
// hi/lo compensated matrix product (a device for the TPU's matrix unit):
// as a sum of squared differences where a lane holds centres, and where a
// lane holds points in the expanded form |p|^2 - 2 c.p < r^2 - |c|^2, with
// |p|^2 taken once per point and chunk and (-2 c, r^2 - |c|^2) once per
// centre, three fused multiply-adds and a compare per test in place of
// seven instructions. With u = 2^-24, the three multiply-adds round by at
// most u (|p| + |c|)^2 each, |p|^2 by 2 u |p|^2 and the right side by
// 3 u |c|^2 + u r^2: under 6 u (|p| + |c|)^2 in all, the size of the plain
// version's own error (it takes the same form). So either form can
// disagree with the plain version only for points whose squared distance
// lies within rounding error (about 1e-5 at room scale) of r^2.
//
// What bounds it: instructions, not bytes. A slot's scan stops at its
// bucket's first hit, so the work depends on the data; a sparse
// neighbourhood (the first layer: r = 0.2 in a room) scans most buckets
// far in, up to B*M*N distance tests of 9 flops. The points of a batch row
// are read from L2 a few hundred times and from device memory once. A
// test in the direct form is 7 floating-point instructions (3
// subtractions, a product, 2 fused multiply-adds, a compare), in the
// expanded form 4; everything else an SM spends on it
// (loads, addresses, loop, branch, the bookkeeping of a hit) is overhead,
// and the first version spent 3 loads and a branch on every test. Two
// mappings of the work, the tile of each chosen per shape by
// ops/ball_query.py::plan:
//
// * A lane holds centres (`bq_centres_kernel<R>`). A block owns
//   32 * R * G centres of one batch row; a lane keeps R of them in
//   registers. Its warps are G centre groups times Q bucket groups. The
//   block walks the live buckets Q at a time, a chunk of 128 points each,
//   staged in shared memory by asynchronous 16-byte copies (cp.async), the
//   next chunk's copy in flight while this one is tested; a bucket starts
//   at a multiple of 128 points, so a chunk is 96 aligned 16-byte pieces
//   of a contiguous row (a row that is not, or a chunk that ends past n,
//   is staged by plain loads and padded far away). A warp reads 8 points
//   with six 16-byte shared loads (a broadcast each) and tests each
//   against its R centres, so a test costs 3 / (4 R) of a load. The hits of
//   a round are bits of a word per centre, resolved with __ffs under a
//   predicate, so the round has no branch; the warp votes once a round
//   (__all_sync) and leaves the bucket when every centre of every lane has
//   its first hit.
// * A lane holds points (`bq_points_kernel`). A warp takes a bucket, a
//   chunk of 128 points at a time, 4 points a lane in registers, and walks
//   the block's centres (16-byte broadcast loads from shared memory): 4
//   tests a lane and one vote; where some lane has a hit, 4 ballots, and
//   the first set bit of the first non-empty ballot is the slot's hit. A
//   centre leaves the bucket at its own first hit, to the chunk (a bit per
//   centre in a register says which are still looking): no lane waits for
//   another, at the price of a vote per 128 tests.
//
// Both skip the buckets past n (all padding) and finish alike: one pass
// resolves the slot-fill in shared memory and writes idx and hit for the
// block's tile with consecutive threads on consecutive addresses. With a
// counter given, every warp adds the tests it executed (for the record of
// executed against needed tests; integers only).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSlots = 64;
constexpr int kChunk = 128;  // points staged, or held by a warp, at a time
constexpr int kRound = 8;    // points tested between two votes
constexpr int kMaxWarps = 16;
constexpr int kMaxCentres = 256;       // centres per block
constexpr int kMaxPointCentres = 32;   // the same where lanes hold points
constexpr int kMaxSmem = 99 * 1024;    // bytes of shared memory per block
constexpr int kChunkFloats = 3 * kChunk;
constexpr float kFar = 1e18f;  // padding: its square is finite and huge
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's epilogue. first[c * (nsample + 1) + s]: the first hit of
// centre c in bucket s as an offset within the bucket, or -1 (read for
// s < live only). Resolves the slot-fill and writes the block's rows.
__device__ void write_tile(const int* first, int* fill, int centres, int b,
                           int m0, int m, int n, int nsample, int bucket,
                           int live, int* __restrict__ idx_out,
                           unsigned char* __restrict__ hit_out) {
  __syncthreads();
  const int stride = nsample + 1;  // odd for an even nsample: no conflicts
  const int rows = min(centres, m - m0);
  for (int c = threadIdx.x; c < rows; c += blockDim.x) {
    int f = 0;  // no hit anywhere: every slot is index 0
    for (int s = 0; s < live; ++s) {
      const int loc = first[c * stride + s];
      if (loc >= 0) {
        f = s * bucket + loc;
        break;
      }
    }
    fill[c] = f;
  }
  __syncthreads();
  const int tile = rows * nsample;
  const long long o = ((long long)b * m + m0) * nsample;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int c = e / nsample;
    const int s = e - c * nsample;
    const int loc = s < live ? first[c * stride + s] : -1;
    const bool hit = loc >= 0;
    idx_out[o + e] = min(hit ? s * bucket + loc : fill[c], n - 1);
    hit_out[o + e] = hit ? 1 : 0;
  }
}

// A lane holds R centres; the points come from shared memory.
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
    bq_centres_kernel(const float* __restrict__ xyz, long long xsb,
                      long long xsn, const float* __restrict__ ctr,
                      long long csb, long long csn, int n, int m, float r2,
                      int nsample, int bucket, int live, int groups,
                      int* __restrict__ idx_out,
                      unsigned char* __restrict__ hit_out,
                      unsigned long long* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qcount = (blockDim.x >> 5) / groups;  // bucket groups
  const int g = warp % groups;
  const int q = warp / groups;
  const int centres = groups * 32 * R;
  // stage[bucket group][buffer][3 * kChunk], points interleaved as in xyz
  float* stage = reinterpret_cast<float*>(smem);
  int* first = reinterpret_cast<int*>(stage + qcount * 2 * kChunkFloats);
  int* fill = first + centres * (nsample + 1);

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * centres;
  float cx[R], cy[R], cz[R];
  bool alive[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = m0 + g * 32 * R + r * 32 + lane;
    alive[r] = c < m;
    cx[r] = cy[r] = cz[r] = 0.f;
    if (alive[r]) {
      const float* p = ctr + b * csb + c * csn;
      cx[r] = p[0];
      cy[r] = p[1];
      cz[r] = p[2];
    }
  }
  const float* row = xyz + b * xsb;
  const bool aligned =
      xsn == 3 && reinterpret_cast<uintptr_t>(row) % 16 == 0;
  const int chunks = bucket / kChunk;
  const int steps = (live + qcount - 1) / qcount;

  // chunk k of the buckets of one step, into buffer `buf`
  auto stage_chunks = [&](int step, int k, int buf) {
    for (int qq = 0; qq < qcount; ++qq) {
      const int s = step * qcount + qq;
      const int start = s * bucket + k * kChunk;
      const int valid = min(kChunk, n - start);
      if (s >= live || valid <= 0) continue;  // no warp reads it
      float* dst = stage + (qq * 2 + buf) * kChunkFloats;
      if (aligned && valid == kChunk) {
        const float4* src =
            reinterpret_cast<const float4*>(row + (long long)start * 3);
        for (int i = tid; i < kChunkFloats / 4; i += blockDim.x)
          cp_async16(reinterpret_cast<float4*>(dst) + i, src + i);
      } else {
        for (int i = tid; i < kChunkFloats; i += blockDim.x) {
          const int p = i / 3;
          dst[i] = p < valid
                       ? __ldg(row + (long long)(start + p) * xsn + (i - 3 * p))
                       : kFar;
        }
      }
    }
    cp_async_commit();
  };

  int found[R];
#pragma unroll
  for (int r = 0; r < R; ++r) found[r] = alive[r] ? -1 : 0;
  bool all_found = false;
  unsigned rounds = 0;
  stage_chunks(0, 0, 0);
  int buf = 0;
  for (int step = 0; step < steps; ++step) {
    const int s = step * qcount + q;
    const int len = s < live ? min(bucket, n - s * bucket) : 0;
    for (int k = 0; k < chunks; ++k, buf ^= 1) {
      // this chunk has landed, and every warp is done with the other buffer
      cp_async_wait_all();
      __syncthreads();
      if (k + 1 < chunks)
        stage_chunks(step, k + 1, buf ^ 1);
      else if (step + 1 < steps)
        stage_chunks(step + 1, 0, buf ^ 1);
      const int base = k * kChunk;
      if (all_found || base >= len) continue;
      const float* pts = stage + (q * 2 + buf) * kChunkFloats;
      const int lim = min(kChunk, len - base);
      for (int j0 = 0; j0 < lim; j0 += kRound) {
        const float4* v = reinterpret_cast<const float4*>(pts + 3 * j0);
        float p[3 * kRound];
#pragma unroll
        for (int i = 0; i < 3 * kRound / 4; ++i) {
          const float4 t = v[i];
          p[4 * i] = t.x;
          p[4 * i + 1] = t.y;
          p[4 * i + 2] = t.z;
          p[4 * i + 3] = t.w;
        }
        unsigned bits[R];
#pragma unroll
        for (int r = 0; r < R; ++r) bits[r] = 0;
#pragma unroll
        for (int u = 0; u < kRound; ++u) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float dx = cx[r] - p[3 * u];
            const float dy = cy[r] - p[3 * u + 1];
            const float dz = cz[r] - p[3 * u + 2];
            if (dx * dx + dy * dy + dz * dz < r2) bits[r] |= 1u << u;
          }
        }
        bool done = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (found[r] < 0 && bits[r] != 0)
            found[r] = base + j0 + __ffs(bits[r]) - 1;
          done = done && found[r] >= 0;
        }
        ++rounds;
        if (__all_sync(kFull, done)) {
          all_found = true;
          break;
        }
      }
    }
    // the bucket is done: record, and start the next with a clean slate
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (s < live)
        first[(g * 32 * R + r * 32 + lane) * (nsample + 1) + s] =
            alive[r] ? found[r] : -1;
      found[r] = alive[r] ? -1 : 0;
    }
    all_found = false;
  }
  if (counter != nullptr && lane == 0)
    atomicAdd(counter, (unsigned long long)rounds * (kRound * 32 * R));
  write_tile(first, fill, centres, b, m0, m, n, nsample, bucket, live,
             idx_out, hit_out);
}

// A lane's 4 points against one centre q = (-2 c, r^2 - |c|^2): d[i] =
// |p_i|^2 - 2 c . p_i, and whether any is inside.
__device__ __forceinline__ bool test4(const float4 q, const float (&px)[4],
                                      const float (&py)[4],
                                      const float (&pz)[4],
                                      const float (&pp)[4], float (&d)[4]) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = fmaf(q.z, pz[i], fmaf(q.y, py[i], fmaf(q.x, px[i], pp[i])));
    any = any || d[i] < q.w;
  }
  return any;
}

// The first point inside among the warp's 128 (some lane has one): ballot i
// covers points 32 i .. 32 i + 31.
__device__ __forceinline__ int first_of4(const float (&d)[4], float bound) {
  unsigned bal[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bal[i] = __ballot_sync(kFull, d[i] < bound);
  const int i = bal[0] ? 0 : bal[1] ? 1 : bal[2] ? 2 : 3;
  const unsigned w = bal[0] ? bal[0] : bal[1] ? bal[1]
                     : bal[2] ? bal[2] : bal[3];
  return 32 * i + __ffs(w) - 1;
}

// A lane holds points; the centres come from shared memory. `pending` has
// a bit per centre of the block that has no hit yet in the warp's bucket.
__global__ void __launch_bounds__(kMaxWarps * 32)
    bq_points_kernel(const float* __restrict__ xyz, long long xsb,
                     long long xsn, const float* __restrict__ ctr,
                     long long csb, long long csn, int n, int m, float r2,
                     int nsample, int bucket, int live, int centres,
                     int* __restrict__ idx_out,
                     unsigned char* __restrict__ hit_out,
                     unsigned long long* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* cen = reinterpret_cast<float4*>(smem);
  int* first = reinterpret_cast<int*>(cen + centres);
  int* fill = first + centres * (nsample + 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int stride = nsample + 1;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * centres;
  const int rows = min(centres, m - m0);  // <= kMaxPointCentres
  // a centre as (-2 cx, -2 cy, -2 cz, r^2 - |c|^2): a point p is inside iff
  // |p|^2 + (-2 c) . p < r^2 - |c|^2
  for (int c = tid; c < rows; c += blockDim.x) {
    const float* p = ctr + b * csb + (long long)(m0 + c) * csn;
    const float x = p[0], y = p[1], z = p[2];
    cen[c] = make_float4(-2.f * x, -2.f * y, -2.f * z,
                         r2 - ((x * x + y * y) + z * z));
  }
  __syncthreads();
  const float* row = xyz + b * xsb;
  unsigned visits = 0;
  for (int s = warp; s < live; s += warps) {
    const int start = s * bucket;
    const int len = min(bucket, n - start);
    int* first_s = first + s;
    for (int c = lane; c < rows; c += 32) first_s[c * stride] = -1;
    __syncwarp();  // before lane 0 records a hit over another lane's -1
    unsigned pending = rows == 32 ? kFull : (1u << rows) - 1;
    for (int k0 = 0; k0 < len && pending != 0; k0 += kChunk) {
      // a lane's 4 points of the chunk: k0 + 32 i + lane, so that ballot i
      // covers points k0 + 32 i .. k0 + 32 i + 31 in order
      float px[4], py[4], pz[4], pp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = k0 + 32 * i + lane;
        px[i] = py[i] = pz[i] = kFar;
        if (j < len) {
          const float* p = row + (long long)(start + j) * xsn;
          px[i] = __ldg(p);
          py[i] = __ldg(p + 1);
          pz[i] = __ldg(p + 2);
        }
        pp[i] = (px[i] * px[i] + py[i] * py[i]) + pz[i] * pz[i];
      }
      visits += __popc(pending);
      for (unsigned todo = pending; todo != 0; todo &= todo - 1) {
        const int c = __ffs(todo) - 1;  // the same in all lanes
        const float4 q = cen[c];
        float d[4];
        // most visits find nothing: one vote for those, the four ballots
        // only where some lane has a hit
        if (__any_sync(kFull, test4(q, px, py, pz, pp, d))) {
          const int at = k0 + first_of4(d, q.w);
          if (lane == 0) first_s[c * stride] = at;
          pending &= ~(1u << c);
        }
      }
    }
  }
  if (counter != nullptr && lane == 0)
    atomicAdd(counter, (unsigned long long)visits * kChunk);
  write_tile(first, fill, centres, b, m0, m, n, nsample, bucket, live,
             idx_out, hit_out);
}

}  // namespace

extern "C" {

// xyz: row b, point i, coordinate k at xyz[b*xsb + i*xsn + k] (float32);
// centres likewise with (csb, csn). idx (b, m, nsample) int32 and hit
// (b, m, nsample) bool, both contiguous.
//
// The tile: `mapping` 0, a lane holds `per_lane` (1, 2 or 4) centres, a
// block `centres` (a multiple of 32 * per_lane) and `warps` warps, a
// multiple of its centres / (32 * per_lane) centre groups; `mapping` 1, a
// lane holds points, a block `centres` centres (any number up to 32) and
// `warps` warps, each over its own buckets. At most 16 warps and 99 KB of
// shared memory a block. `counter`, if not null, receives the distance
// tests executed (added to what it holds).
//
// Returns the cudaError_t of the launch (0 on success).
int bq_stratified_launch(const float* xyz, long long xsb, long long xsn,
                         const float* ctr, long long csb, long long csn,
                         int b, int n, int m, float r2, int nsample,
                         int bucket, int mapping, int centres, int warps,
                         int per_lane, int* idx, unsigned char* hit,
                         unsigned long long* counter, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || nsample <= 0 ||
      nsample > kMaxSlots || bucket <= 0 || bucket % kChunk != 0 ||
      (long long)bucket * nsample < n || warps < 1 || warps > kMaxWarps ||
      centres < 1 || centres > kMaxCentres)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int live = (n + bucket - 1) / bucket;  // buckets that hold a point
  const dim3 grid((m + centres - 1) / centres, b);
  const long long table =
      ((long long)centres * (nsample + 1) + centres) * sizeof(int);
  cudaError_t err;
  if (mapping == 0) {
    if ((per_lane != 1 && per_lane != 2 && per_lane != 4) ||
        centres % (32 * per_lane) != 0)
      return (int)cudaErrorInvalidValue;
    const int groups = centres / (32 * per_lane);
    if (warps % groups != 0) return (int)cudaErrorInvalidValue;
    const long long bytes =
        table + (long long)(warps / groups) * 2 * kChunkFloats * sizeof(float);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kernel = per_lane == 1   ? &bq_centres_kernel<1>
                  : per_lane == 2 ? &bq_centres_kernel<2>
                                  : &bq_centres_kernel<4>;
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, warps * 32, bytes, st>>>(xyz, xsb, xsn, ctr, csb, csn, n,
                                            m, r2, nsample, bucket, live,
                                            groups, idx, hit, counter);
  } else if (mapping == 1) {
    if (centres > kMaxPointCentres) return (int)cudaErrorInvalidValue;
    const long long bytes = table + (long long)centres * sizeof(float4);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(
          bq_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    bq_points_kernel<<<grid, warps * 32, bytes, st>>>(
        xyz, xsb, xsn, ctr, csb, csn, n, m, r2, nsample, bucket, live,
        centres, idx, hit, counter);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
