// Ball queries for Hopper (sm_90a), plain C interface: the stratified
// query (`bq_stratified_launch`) and the exact first-k query
// (`bq_exact_launch`, at the end of the file).
//
// The stratified query replaces the Pallas TPU kernel
// `_bq_stratified_kernel` in backtoreality_tpu/ops/ball_query.py, together
// with the slot-fill and the clamp to n-1 that its wrapper runs in XLA
// afterwards.
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
// hi/lo compensated matrix product (a device for the TPU's matrix unit),
// in the expanded form |p|^2 - 2 c.p < r^2 - |c|^2, with |p|^2 taken once
// per point and (-2 c, r^2 - |c|^2) once per centre: three fused
// multiply-adds and a compare per test (`inside`). Both mappings below
// decide every (centre, point) pair by these same operations in the same
// order, each square and sum rounded on its own (`sq3`), so a row's slots
// do not depend on the tile, and so not on how many rows a launch holds.
// With u = 2^-24, the three multiply-adds round by at most u (|p| + |c|)^2
// each, |p|^2 by 2 u |p|^2 and the right side by 3 u |c|^2 + u r^2: under
// 6 u (|p| + |c|)^2 in all, the size of the plain version's own error (it
// takes the same form, with the products summed by a matrix product). So
// the kernel can disagree with the plain version only for points whose
// squared distance lies within rounding error (about 1e-5 at room scale)
// of r^2.
//
// What bounds it: instructions, not bytes. A slot's scan stops at its
// bucket's first hit, so the work depends on the data; a sparse
// neighbourhood (the first layer: r = 0.2 in a room) scans most buckets
// far in, up to B*M*N distance tests of 9 flops. The points of a batch row
// are read from L2 a few hundred times and from device memory once. A
// test is 4 floating-point instructions (3 fused multiply-adds and a
// compare), and |p|^2 5 more a point, shared by a lane's centres;
// everything else an SM spends on it
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

// |v|^2 as (x*x + y*y) + z*z, every product and sum rounded on its own (no
// contraction into a multiply-add): as the plain version takes it, and the
// same in both mappings.
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// A centre as q = (-2 cx, -2 cy, -2 cz, r^2 - |c|^2).
__device__ __forceinline__ float4 centre_query(const float* c, float r2) {
  return make_float4(-2.f * c[0], -2.f * c[1], -2.f * c[2],
                     __fsub_rn(r2, sq3(c[0], c[1], c[2])));
}

// |p|^2 - 2 c . p against r^2 - |c|^2, for q = centre_query(c) and
// pp = |p|^2: whether p lies inside the ball. `d` gets the left side.
__device__ __forceinline__ bool inside(const float4 q, float x, float y,
                                       float z, float pp, float& d) {
  d = fmaf(q.z, z, fmaf(q.y, y, fmaf(q.x, x, pp)));
  return d < q.w;
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
  float4 cq[R];  // centre_query of each centre (nothing is inside a dead one)
  bool alive[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = m0 + g * 32 * R + r * 32 + lane;
    alive[r] = c < m;
    cq[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (alive[r]) cq[r] = centre_query(ctr + b * csb + c * csn, r2);
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
          const float x = p[3 * u], y = p[3 * u + 1], z = p[3 * u + 2];
          const float pp = sq3(x, y, z);  // once for the lane's R centres
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float d;
            if (inside(cq[r], x, y, z, pp, d)) bits[r] |= 1u << u;
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

// A lane's 4 points against one centre q = centre_query(c): d[i] =
// |p_i|^2 - 2 c . p_i, and whether any is inside.
__device__ __forceinline__ bool test4(const float4 q, const float (&px)[4],
                                      const float (&py)[4],
                                      const float (&pz)[4],
                                      const float (&pp)[4], float (&d)[4]) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = inside(q, px[i], py[i], pz[i], pp[i], d[i]);
    any = any || in;
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
  for (int c = tid; c < rows; c += blockDim.x)
    cen[c] = centre_query(ctr + b * csb + (long long)(m0 + c) * csn, r2);
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
        pp[i] = sq3(px[i], py[i], pz[i]);
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


// ---------------------------------------------------------------------------
// The exact first-k query (`_ball_query_exact_torch` in ops/ball_query.py;
// the JAX package leaves it to XLA, backtoreality_tpu/ops/ball_query.py:71):
// slot s of a centre takes its (s+1)-th point in index order with
// |c - p|^2 < r^2; slots past its count take its first hit, and a centre
// with no hit takes index 0 in every slot.
//
// What bounds it: issue slots, as the stratified query. The work depends
// on the data: a centre scans up to its nsample-th hit (at the first layer,
// r = 0.2 in a room, about 4/5 of its row on average). A test is 4
// floating-point instructions (3 fused multiply-adds and a compare, the
// stratified kernels' `inside`), |p|^2 5 more a point; everything else
// (loads, the bookkeeping of ranks) is overhead. Two mappings, the tile of
// each chosen per shape by ops/ball_query.py::exact_plan:
//
// * A lane holds points (`bq_exact_kernel`). A warp holds a centre; a
//   block holds kExactWarps centres of one batch row, which walk the same
//   points in the same order, so the row's points come from L2 once and
//   from L1 for the others. The warp walks the row 128 points at a time, 4
//   a lane, and a ballot per point of a lane gives the hits; a hit's rank
//   is the count so far plus the hits before it in index order. The warp
//   leaves the row once it has nsample hits (the count is the same in
//   every lane): it tests at most 127 points past the one its last slot
//   takes. The slots need no staging, so nsample has no limit, and it is
//   templated on float64. Its price: each test pays its own |p|^2 and a
//   third of a 16-byte load from L1, and 4 ballots and popc every 4
//   points; a row of 40000 points (480 KB) does not fit an SM's L1, so the
//   block's warps share only what they read close together.
// * A lane holds centres (`bq_exact_centres_kernel<R>`, float32). A block
//   owns 32 * R * G centres of one batch row; a lane keeps R of them as
//   `centre_query` values in registers. Its warps are G centre groups
//   times Q chunk groups. The block walks its row in rounds of Q chunks of
//   kRowChunk points, each round staged once for all its warps: copied
//   into shared memory while the round before is tested, by one
//   cp.async.bulk (the TMA's 1-D copy, completion on an mbarrier; 16-byte
//   cp.async, as K3 stages, measured no faster on an H100), then
//   written into a ring of two stages as (x, y, z, |p|^2), |p|^2 taken
//   once a point for the whole block. The
//   copy takes the row as it lies, 3 values a point or 4 (SA1's xyz, the
//   first 3 of each point's 4 values, needs no copy of its own first): the
//   whole 16-byte pieces of an aligned row are copied so; the points past
//   them, and every point of a row that is not aligned, are staged by
//   plain loads guarded by n. Nothing is padded: bits past n are masked. Chunk group q tests chunk q of the round: a warp reads a point
//   with one 16-byte shared load (a broadcast) and tests it against its R
//   centres, keeping each centre's hits as bits (a word per 32 points), so
//   a test costs 1 / R of a load and no square. The round's hit counts go
//   to shared memory; a prefix over the Q chunks in chunk order gives each
//   chunk's first rank, and a lane writes its set bits' indices (__ffs) at
//   the ranks below nsample into a slot table in shared memory (stride
//   nsample + 1). No point is tested twice. The block leaves after the
//   round in which every one of its centres has nsample hits
//   (__syncthreads_and): it waits for its slowest centre, at most a round
//   past that one's last slot. The slots and the fill are written at the
//   end, consecutive threads on consecutive addresses. The table has to
//   fit beside the stages: the plan offers no such tile where it does not.
//
// The radius test is the stratified kernels' in float32 (`inside`, the
// same operations in the same order) in both mappings, so the two give the
// same slots bit for bit, and a centre's first hit is the global first hit
// those kernels' slot-fill takes; in float64 it is the plain version's
// direct form (dx*dx + dy*dy) + dz*dz < r^2, each product and sum rounded
// on its own, which it equals bit for bit. With a counter given, the
// tests executed are added to it: a centre's points up to its exit where
// lanes hold points, the block's live centres times the points its rounds
// walked (up to n) where lanes hold centres.

constexpr int kExactWarps = 8;    // centres a block, where lanes hold points
constexpr int kExactPerLane = 4;  // points a lane tests between two exits
constexpr int kExactChunk = 32 * kExactPerLane;
constexpr int kRowChunk = 64;     // points a warp tests a round, lanes on centres
constexpr int kRowWords = kRowChunk / 32;  // words of hit bits a centre
constexpr int kRingStages = 2;  // rounds of squared points

template <typename T>
struct Ball;

template <>
struct Ball<float> {
  float4 q;
  __device__ Ball(const float* c, double r2) : q(centre_query(c, (float)r2)) {}
  __device__ __forceinline__ bool contains(float x, float y, float z) const {
    float d;
    return inside(q, x, y, z, sq3(x, y, z), d);
  }
  // a lane's 4 consecutive points, from a 16-byte aligned address
  __device__ static void load4(const float* p, float (&v)[12]) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 t = __ldg(q + i);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  }
};

template <>
struct Ball<double> {
  double cx, cy, cz, r2;
  __device__ Ball(const double* c, double r2_)
      : cx(c[0]), cy(c[1]), cz(c[2]), r2(r2_) {}
  __device__ __forceinline__ bool contains(double x, double y,
                                           double z) const {
    const double dx = __dsub_rn(cx, x), dy = __dsub_rn(cy, y),
                 dz = __dsub_rn(cz, z);
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
                     __dmul_rn(dz, dz)) < r2;
  }
  __device__ static void load4(const double* p, double (&v)[12]) {
    const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const double2 t = __ldg(q + i);
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kExactWarps * 32)
    bq_exact_kernel(const T* __restrict__ xyz, long long xsb,
                    const T* __restrict__ ctr, long long csb, long long csn,
                    int n, int m, double r2, int nsample,
                    int* __restrict__ idx_out,
                    unsigned long long* __restrict__ counter) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kExactWarps + (threadIdx.x >> 5);
  if (c >= m) return;  // the whole warp
  const int b = blockIdx.y;
  const Ball<T> ball(ctr + b * csb + c * csn, r2);
  const T* row = xyz + b * xsb;
  int* out = idx_out + ((long long)b * m + c) * nsample;
  const unsigned below = (1u << lane) - 1;
  const bool aligned = reinterpret_cast<uintptr_t>(row) % 16 == 0;
  int count = 0;  // hits so far, the same in every lane
  int first = 0;  // the first hit (0 if none)
  long long tested = 0;
  for (int base = 0; base < n && count < nsample; base += kExactChunk) {
    const int at = base + kExactPerLane * lane;
    const T* p = row + 3LL * at;
    T v[3 * kExactPerLane];
    bool in[kExactPerLane];
    if (aligned && base + kExactChunk <= n) {  // the same in every lane
      Ball<T>::load4(p, v);
#pragma unroll
      for (int u = 0; u < kExactPerLane; ++u)
        in[u] = ball.contains(v[3 * u], v[3 * u + 1], v[3 * u + 2]);
    } else {
#pragma unroll
      for (int u = 0; u < kExactPerLane; ++u) {
        in[u] = at + u < n;
        if (in[u])
          in[u] = ball.contains(__ldg(p + 3 * u), __ldg(p + 3 * u + 1),
                                __ldg(p + 3 * u + 2));
      }
    }
    unsigned any = 0;
    int before = 0, hits = 0;
#pragma unroll
    for (int u = 0; u < kExactPerLane; ++u) {
      const unsigned vote = __ballot_sync(kFull, in[u]);
      before += __popc(vote & below);
      hits += __popc(vote);
      any |= vote;
    }
    if (count == 0 && any != 0) {
      // the lowest lane with a hit holds the first, at its lowest u
      const int l = __ffs(any) - 1;
      int u0 = 0;
#pragma unroll
      for (int u = kExactPerLane - 1; u >= 0; --u)
        if (in[u]) u0 = u;
      first = base + kExactPerLane * l + __shfl_sync(kFull, u0, l);
    }
    int rank = count + before;
#pragma unroll
    for (int u = 0; u < kExactPerLane; ++u) {
      if (in[u]) {
        if (rank < nsample) out[rank] = at + u;
        ++rank;
      }
    }
    count += hits;
    tested += min(kExactChunk, n - base);
  }
  for (int s = min(count, nsample) + lane; s < nsample; s += 32)
    out[s] = first;
  if (counter != nullptr && lane == 0)
    atomicAdd(counter, (unsigned long long)tested);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive, expecting `bytes` from the copy that follows (0: none)
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// until the phase of `parity` has completed; a wait that never ends
// (a copy that never lands) traps, so the launch fails instead of holding
// the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the TMA, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A lane holds R centres; the points come from shared memory, a round of
// `qcount` chunks at a time (see the note above).
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
    bq_exact_centres_kernel(const float* __restrict__ xyz, long long xsb,
                            int xsn, const float* __restrict__ ctr,
                            long long csb, long long csn, int n, int m,
                            float r2, int nsample, int groups,
                            int* __restrict__ idx_out,
                            unsigned long long* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qcount = (blockDim.x >> 5) / groups;  // chunk groups
  const int g = warp % groups;
  const int q = warp / groups;
  const int centres = groups * 32 * R;
  const int span = qcount * kRowChunk;  // points a round
  const int stride = nsample + 1;       // odd for an even nsample
  // the copy's barrier, the copied round (xsn * span floats, as in xyz),
  // the ring [stage][span] of points as (x, y, z, |p|^2), the round's
  // counts [chunk group][centre], the hits so far [centre], the slots
  // [centre][stride]
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* raw = reinterpret_cast<float*>(smem + 16);
  float4* ring = reinterpret_cast<float4*>(raw + 4 * span);
  int* counts = reinterpret_cast<int*>(ring + kRingStages * span);
  int* total = counts + qcount * centres;
  int* slots = total + centres;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * centres;
  float4 cq[R];  // centre_query of each centre (nothing is inside a dead one)
  bool alive[R];
  int have[R];  // hits so far, the same in each chunk group
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = m0 + g * 32 * R + r * 32 + lane;
    alive[r] = c < m;
    cq[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (alive[r]) cq[r] = centre_query(ctr + b * csb + c * csn, r2);
    have[r] = 0;
  }
  const float* row = xyz + b * xsb;
  const bool aligned = reinterpret_cast<uintptr_t>(row) % 16 == 0;
  const int rounds = (n + span - 1) / span;
  if (tid == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // round k into `raw`, as the row lays it out: where the row is aligned,
  // its whole 16-byte pieces (a point each at 4 values a point, but the
  // row's last, whose fourth value may lie past the tensor; the whole
  // 4-point groups at 3) by the bulk copy, the rest's coordinates by
  // plain loads
  auto copy = [&](int k) {
    const int base = k * span;
    const int len = min(span, n - base);
    const int vec = !aligned      ? 0
                    : xsn == 3    ? len & ~3
                    : base + len == n ? len - 1
                                      : len;
    const float* src = row + (long long)xsn * base;
    if (tid == 0) {
      // every thread's reads and writes of `raw` come before
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(bar, vec * xsn * 4);
      if (vec > 0) bulk_copy(raw, src, vec * xsn * 4, bar);
    }
    for (int i = vec * xsn + tid; i < len * xsn; i += blockDim.x)
      if (i % xsn < 3) raw[i] = __ldg(src + i);
  };
  // the copied round k into its stage, |p|^2 taken once a point
  auto square = [&](int k) {
    float4* dst = ring + (k % kRingStages) * span;
    const int len = min(span, n - k * span);
    for (int i = tid; i < len; i += blockDim.x) {
      const float* v = raw + xsn * i;
      const float x = v[0], y = v[1], z = v[2];
      dst[i] = make_float4(x, y, z, sq3(x, y, z));
    }
  };

  copy(0);
  mbar_wait(bar, 0);
  __syncthreads();
  square(0);
  __syncthreads();
  int walked = 0;
  for (int k = 0;; ++k) {
    // `raw` was squared before the last barrier
    if (k + 1 < rounds) copy(k + 1);
    const int base = k * span + q * kRowChunk;
    const int lim = n - base;  // points of the chunk below n (may be <= 0)
    unsigned bits[R][kRowWords];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int w = 0; w < kRowWords; ++w) bits[r][w] = 0;
    if (lim > 0) {
      const float4* pts = ring + (k % kRingStages) * span + q * kRowChunk;
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j) {
        const float4 p = pts[j];  // a broadcast
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float d;
          if (inside(cq[r], p.x, p.y, p.z, p.w, d))
            bits[r][j / 32] |= 1u << (j % 32);
        }
      }
      if (lim < kRowChunk) {  // the points past n were never staged
#pragma unroll
        for (int w = 0; w < kRowWords; ++w) {
          const int valid = min(max(lim - 32 * w, 0), 32);
          const unsigned mask = valid == 32 ? kFull : (1u << valid) - 1;
#pragma unroll
          for (int r = 0; r < R; ++r) bits[r][w] &= mask;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int cnt = 0;
#pragma unroll
      for (int w = 0; w < kRowWords; ++w) cnt += __popc(bits[r][w]);
      counts[q * centres + g * 32 * R + r * 32 + lane] = cnt;
    }
    if (k + 1 < rounds) mbar_wait(bar, (k + 1) & 1);
    // the counts are in, and the next round's copy has landed
    __syncthreads();
    if (k + 1 < rounds) square(k + 1);
    // ranks: the hits so far, then the chunks before this one in order
    bool done = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = g * 32 * R + r * 32 + lane;
      int rank = have[r];
      for (int qq = 0; qq < qcount; ++qq) {
        const int v = counts[qq * centres + c];
        if (qq < q) rank += v;
        have[r] += v;
      }
#pragma unroll
      for (int w = 0; w < kRowWords; ++w) {
        for (unsigned word = bits[r][w]; word != 0 && rank < nsample;
             word &= word - 1)
          slots[c * stride + rank++] = base + 32 * w + __ffs(word) - 1;
      }
      done = done && (!alive[r] || have[r] >= nsample);
    }
    // every warp is done with the counts and this round's stage, and the
    // next round is squared into its own
    if (__syncthreads_and(done) || k + 1 == rounds) {
      walked = min((k + 1) * span, n);
      break;
    }
  }
  if (q == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) total[g * 32 * R + r * 32 + lane] = have[r];
  }
  __syncthreads();
  const int rows = min(centres, m - m0);
  int* out = idx_out + ((long long)b * m + m0) * nsample;
  for (int e = tid; e < rows * nsample; e += blockDim.x) {
    const int c = e / nsample;
    const int s = e - c * nsample;
    const int t = total[c];
    out[e] = s < t ? slots[c * stride + s] : t > 0 ? slots[c * stride] : 0;
  }
  if (counter != nullptr && tid == 0)
    atomicAdd(counter, (unsigned long long)rows * walked);
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

// The exact first-k query. xyz: row b, point i, coordinate k at
// xyz[b*xsb + xsn*i + k], xsn 3 (4 too where lanes hold centres: SA1's
// xyz, the first 3 of each point's 4 values); centres as above, with
// (csb, csn); float32 (`dbl`
// 0) or float64 (`dbl` 1), r2 = radius^2 as a double (rounded to float32
// for float32 inputs); idx (b, m, nsample) int32, contiguous.
//
// The tile: `mapping` 1, a lane holds points: `centres` and `warps` both
// kExactWarps, `per_lane` 1; `mapping` 0, a lane holds centres
// (float32 only): `per_lane` (1, 2 or 4) centres a lane, `centres` a block
// (a multiple of 32 * per_lane, at most 256), `warps` (at most 16) a
// multiple of its centres / (32 * per_lane) centre groups, and the
// stages, the counts and the slot table within 99 KB of shared memory. `counter`, if not null,
// receives the distance tests executed (added to what it holds).
//
// Returns the cudaError_t of the launch (0 on success); any other tile is
// cudaErrorInvalidValue.
int bq_exact_launch(const void* xyz, long long xsb, long long xsn,
                    const void* ctr, long long csb, long long csn, int b,
                    int n, int m,
                    double r2, int nsample, int dbl, int mapping,
                    int centres, int warps, int per_lane, int* idx,
                    unsigned long long* counter, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || nsample <= 0 ||
      (dbl != 0 && dbl != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mapping == 1) {
    if (xsn != 3 || centres != kExactWarps || warps != kExactWarps ||
        per_lane != 1)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((m + kExactWarps - 1) / kExactWarps, b);
    if (dbl)
      bq_exact_kernel<double><<<grid, kExactWarps * 32, 0, st>>>(
          static_cast<const double*>(xyz), xsb,
          static_cast<const double*>(ctr), csb, csn, n, m, r2, nsample, idx,
          counter);
    else
      bq_exact_kernel<float><<<grid, kExactWarps * 32, 0, st>>>(
          static_cast<const float*>(xyz), xsb,
          static_cast<const float*>(ctr), csb, csn, n, m, r2, nsample, idx,
          counter);
    return (int)cudaGetLastError();
  }
  if (mapping != 0 || dbl != 0 || (xsn != 3 && xsn != 4) ||
      (per_lane != 1 && per_lane != 2 && per_lane != 4) || centres < 1 ||
      centres > kMaxCentres || centres % (32 * per_lane) != 0 ||
      warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const int groups = centres / (32 * per_lane);
  if (warps % groups != 0) return (int)cudaErrorInvalidValue;
  const long long span = (long long)(warps / groups) * kRowChunk;
  const long long bytes =
      16 + 4 * span * (long long)sizeof(float) +
      kRingStages * span * (long long)sizeof(float4) +
      ((warps / groups) * (long long)centres + centres +
       (long long)centres * (nsample + 1)) * (long long)sizeof(int);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = per_lane == 1   ? &bq_exact_centres_kernel<1>
                : per_lane == 2 ? &bq_exact_centres_kernel<2>
                                : &bq_exact_centres_kernel<4>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + centres - 1) / centres, b);
  kernel<<<grid, warps * 32, bytes, st>>>(
      static_cast<const float*>(xyz), xsb, (int)xsn,
      static_cast<const float*>(ctr), csb, csn, n, m, (float)r2, nsample,
      groups, idx, counter);
  return (int)cudaGetLastError();
}

}  // extern "C"
