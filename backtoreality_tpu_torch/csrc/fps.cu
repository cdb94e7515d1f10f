// Furthest point sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels `_fps_kernel` (whole batch, one grid
// step) and `_fps_kernel_row` (one batch row per grid step) in
// backtoreality_tpu/ops/fps.py; both compute the same function. Here
// `fps_reg_kernel` serves every row that fits a thread-block cluster's
// registers and `fps_capacity_kernel` the rows that do not, as the
// per-row kernel stood beside the whole-batch one.
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
// What bounds it: not bytes and not operations but a serial chain. The
// npoint samples are strictly sequential, and each is a sweep over the row
// (about 10 operations a point) followed by a row-wide argmax whose result
// every thread needs before the next sweep can start. One block per row
// with its state in shared memory (the first version of this file) used 8
// of 132 SMs and paid two block barriers, ten shuffle rounds and a
// dependent read of the winner's coordinates per sample. What remains
// with an empty sweep, the serial floor of one sample on an H100, is about
// 0.14 us in one warp, 0.31 us in a block of four warps and 0.47 to 0.75 us
// across a cluster of 2 to 16 blocks.
//
// Design of `fps_reg_kernel`:
//   * State in registers. A thread owns P points (P a template constant,
//     the loops unrolled): x, y, z and the running min-distance never
//     leave its registers, so a sweep touches no memory at all.
//   * A row is shared by the R blocks of a thread-block cluster (R = 1 for
//     a small row), so up to 16 SMs sweep one row. Block r owns the
//     indices [r*T*P, (r+1)*T*P); thread t of it the indices
//     r*T*P + p*T + t. Indices past n behave as padding.
//   * One packed key per candidate. The field is >= 0 or exactly -1, so
//     its bits with the sign flipped order as the floats do, as unsigned
//     integers. A warp's best is `__reduce_max_sync` on the key and then
//     `__reduce_min_sync` on the index among the lanes that hold it: two
//     instructions, and ties go to the lowest index.
//   * One exchange per sample, and no second barrier. Every warp writes
//     its winner (key, index and the winner's coordinates, read from a
//     table in the block's own shared memory) into its slot in every block
//     of the cluster, then every warp reduces all R*T/32 slots itself and
//     so holds the next reference point. In one block the write is a
//     shared-memory store and the wait a `__syncthreads`. Across a
//     cluster, lane r sends the slot to block r with `st.async`, a store
//     through distributed shared memory that counts its bytes against an
//     mbarrier of the receiving block; each warp announces the bytes it
//     expects and waits on its own block's mbarrier. That is one one-way
//     message where a cluster barrier is a store, a release, an arrival
//     and a wait (measured: 0.74 against 1.41 us a sample at 16 blocks).
//     The slots and their mbarriers alternate between two buffers with
//     the sample's parity: a block can send sample j+2 only after it has
//     received every warp's sample j+1, which a warp sends only after it
//     has read sample j.
//     One warp per row (R = 1, T = 32) needs no slot and no barrier.
//   * The kernel starts and ends with a cluster barrier: no block writes
//     into a peer that has not started and set up its mbarriers, none
//     leaves while a peer may still write into it.
//
// The wrapper (ops/fps.py) picks R, T and P from the shape alone, after
// asking `fps_max_clusters` how many clusters of that size the card can
// hold at once.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kPadNorm2 = 1e-3f;
constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;  // registers: 65536 / 512 = 128 a thread
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Orders a field value (>= 0, or -1) as an unsigned integer.
__device__ __forceinline__ unsigned field_key(float v) {
  return __float_as_uint(v) ^ 0x80000000u;
}

// The best (key, index) over the warp: largest key, then lowest index.
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == top ? idx : UINT_MAX);
  key = top;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address, in the cluster's window, of block `rank`'s copy of a
// shared-memory address of this block.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned mapped;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(mapped) : "r"(addr), "r"(rank));
  return mapped;
}

// Asynchronous stores into a peer's shared memory: the bytes count
// against the peer's mbarrier as they land, so the peer that sees its
// barrier complete sees the data.
__device__ __forceinline__ void send4(unsigned dst, unsigned bar, unsigned a,
                                      unsigned b, unsigned c, unsigned d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
      " [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar) : "memory");
}
__device__ __forceinline__ void send1(unsigned dst, unsigned bar,
                                      unsigned a) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0], %1, [%2];"
      :: "r"(dst), "r"(a), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive_expect(unsigned bar,
                                                  unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Spins until the barrier has left the phase of this parity.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// A slot is 20 bytes in two arrays: (key, index, x, y) and z.
constexpr unsigned kSlotBytes = sizeof(uint4) + sizeof(float);
constexpr int kSerialSlots = 8;  // up to here a lane reads every slot

// Shared memory of a block with `threads` threads of `points` points in a
// cluster of `cluster` blocks: two buffers of slots, then the table of the
// block's own coordinates.
inline int slot_count(int cluster, int threads) {
  return cluster * (threads / 32);
}
inline size_t reg_smem_bytes(int cluster, int threads, int points) {
  return 2ull * slot_count(cluster, threads) * kSlotBytes +
         3ull * threads * points * sizeof(float);
}

// The best of one buffer's slots, the same in every lane: its index and
// coordinates.
__device__ __forceinline__ void best_slot(const uint4* __restrict__ slot_a,
                                          const float* __restrict__ slot_z,
                                          int nslots, int lane,
                                          unsigned& idx, float& rx,
                                          float& ry, float& rz) {
  uint4 best = make_uint4(0u, UINT_MAX, 0u, 0u);  // below the key of -1
  if (nslots <= kSerialSlots) {
    int at = 0;
#pragma unroll 4
    for (int s = 0; s < nslots; ++s) {
      const uint4 c = slot_a[s];
      if (c.x > best.x || (c.x == best.x && c.y < best.y)) {
        best = c;
        at = s;
      }
    }
    rz = slot_z[at];
  } else {
    int at = 0;
    for (int s = lane; s < nslots; s += 32) {
      const uint4 c = slot_a[s];
      if (c.x > best.x || (c.x == best.x && c.y < best.y)) {
        best = c;
        at = s;
      }
    }
    unsigned key = best.x, low = best.y;
    warp_best(key, low);
    // an index names one point, so exactly one slot holds the winner
    const unsigned holder =
        __ballot_sync(kFull, best.x == key && best.y == low);
    at = __shfl_sync(kFull, at, __ffs(holder) - 1);
    best = slot_a[at];
    rz = slot_z[at];
  }
  idx = best.y;
  rx = __uint_as_float(best.z);
  ry = __uint_as_float(best.w);
}

template <int P, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
    fps_reg_kernel(const float* __restrict__ xyz, long long sb, long long sn,
                   int n, int npoint, int* __restrict__ out) {
  extern __shared__ uint4 smem[];
  __shared__ unsigned long long bars[2];  // one mbarrier per slot buffer
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int rank = blockIdx.x;  // the grid's x extent is the cluster
  const int nblocks = gridDim.x;
  const int nslots = nblocks * nwarps;
  const int b = blockIdx.y;
  const int base = rank * nt * P;
  const bool exchange = nslots > 1;

  uint4* slot_a = smem;                                       // [2][nslots]
  float* slot_z = reinterpret_cast<float*>(slot_a + 2 * nslots);  // same
  float* tx = slot_z + 2 * nslots;                            // [nt * P]
  float* ty = tx + nt * P;
  float* tz = ty + nt * P;

  const float* row = xyz + b * sb;
  float x[P], y[P], z[P], mind[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int local = p * nt + tid;
    const int i = base + local;
    x[p] = y[p] = z[p] = 0.f;
    mind[p] = -1.f;
    if (i < n) {
      const float* q = row + i * sn;
      x[p] = q[0];
      y[p] = q[1];
      z[p] = q[2];
      if (sq3(x[p], y[p], z[p]) > kPadNorm2) mind[p] = kBig;
    }
    tx[local] = x[p];
    ty[local] = y[p];
    tz[local] = z[p];
  }
  float rx = row[0], ry = row[1], rz = row[2];
  int* out_row = out + (long long)b * npoint;
  const bool writer = rank == 0 && tid == 0;
  if (writer) out_row[0] = 0;

  // this warp's slot (buffer 0), here and, for lane r, in block r
  const int mine = rank * nwarps + warp;
  unsigned peer_a = 0, peer_z = 0, peer_bar = 0;
  if constexpr (kCluster) {
    if (tid == 0) {
      bar_init(smem_addr(&bars[0]), nwarps);
      bar_init(smem_addr(&bars[1]), nwarps);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (lane < nblocks) {
      peer_a = peer_addr(smem_addr(&slot_a[mine]), lane);
      peer_z = peer_addr(smem_addr(&slot_z[mine]), lane);
      peer_bar = peer_addr(smem_addr(&bars[0]), lane);
    }
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  for (int j = 1; j < npoint; ++j) {
    float bv = -2.f;  // below every field value, so bi is always set
    int bi = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float d =
          sq3(__fsub_rn(x[p], rx), __fsub_rn(y[p], ry), __fsub_rn(z[p], rz));
      const float v = fminf(mind[p], d);
      mind[p] = v;
      if (v > bv) {  // indices grow with p: keeps the first maximum
        bv = v;
        bi = base + p * nt + tid;
      }
    }
    unsigned key = field_key(bv);
    unsigned idx = (unsigned)bi;
    warp_best(key, idx);
    // the warp's winner is one of the block's own points
    const int local = (int)idx - base;
    const float wx = tx[local], wy = ty[local], wz = tz[local];
    if (!exchange) {
      rx = wx;
      ry = wy;
      rz = wz;
    } else {
      const int buf = j & 1;
      if constexpr (kCluster) {
        if (lane < nblocks) {
          const unsigned bar = peer_bar + buf * (unsigned)sizeof(bars[0]);
          const unsigned at = buf * nslots;
          send4(peer_a + at * (unsigned)sizeof(uint4), bar, key, idx,
                __float_as_uint(wx), __float_as_uint(wy));
          send1(peer_z + at * (unsigned)sizeof(float), bar,
                __float_as_uint(wz));
        }
        // the buffer is full when every warp here has arrived and the
        // nslots * kSlotBytes bytes it announced have landed
        const unsigned bar = smem_addr(&bars[buf]);
        if (lane == 0) bar_arrive_expect(bar, nblocks * kSlotBytes);
        bar_wait(bar, ((j - 1) >> 1) & 1);
      } else {
        if (lane == 0) {
          slot_a[buf * nslots + mine] = make_uint4(
              key, idx, __float_as_uint(wx), __float_as_uint(wy));
          slot_z[buf * nslots + mine] = wz;
        }
        __syncthreads();
      }
      best_slot(slot_a + buf * nslots, slot_z + buf * nslots, nslots, lane,
                idx, rx, ry, rz);
    }
    if (writer) out_row[j] = (int)idx;
  }
  if constexpr (kCluster) cg::this_cluster().sync();
}

// Rows too large for a cluster's registers: one block per row, the
// min-distance field in a global scratch buffer, the coordinates re-read
// through L2 on every sweep.
__global__ void __launch_bounds__(1024)
    fps_capacity_kernel(const float* __restrict__ xyz, long long sb,
                        long long sn, int n, int npoint,
                        int* __restrict__ out, float* __restrict__ field) {
  __shared__ uint2 slot[2][32];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int b = blockIdx.x;
  const float* row = xyz + b * sb;
  float* mind = field + (long long)b * n;

  for (int i = tid; i < n; i += nt) {
    const float* q = row + i * sn;
    mind[i] = sq3(q[0], q[1], q[2]) > kPadNorm2 ? kBig : -1.0f;
  }
  int* out_row = out + (long long)b * npoint;
  if (tid == 0) out_row[0] = 0;
  int last = 0;

  for (int j = 1; j < npoint; ++j) {
    const float* q = row + last * sn;
    const float rx = q[0], ry = q[1], rz = q[2];
    float bv = -2.f;
    int bi = 0;
    for (int i = tid; i < n; i += nt) {
      const float* p = row + i * sn;
      const float d = sq3(__fsub_rn(__ldg(p), rx), __fsub_rn(__ldg(p + 1), ry),
                          __fsub_rn(__ldg(p + 2), rz));
      const float v = fminf(mind[i], d);
      mind[i] = v;
      if (v > bv) {
        bv = v;
        bi = i;
      }
    }
    unsigned key = field_key(bv);
    unsigned idx = (unsigned)bi;
    warp_best(key, idx);
    if (lane == 0) slot[j & 1][warp] = make_uint2(key, idx);
    __syncthreads();
    const uint2 ki = lane < nwarps ? slot[j & 1][lane]
                                   : make_uint2(0u, UINT_MAX);
    key = ki.x;
    idx = ki.y;
    warp_best(key, idx);
    last = (int)idx;
    if (tid == 0) out_row[j] = last;
  }
}

using RegKernel = void (*)(const float*, long long, long long, int, int,
                           int*);

template <bool kCluster>
RegKernel reg_kernel_for(int points) {
  switch (points) {
    case 1: return fps_reg_kernel<1, kCluster>;
    case 2: return fps_reg_kernel<2, kCluster>;
    case 4: return fps_reg_kernel<4, kCluster>;
    case 8: return fps_reg_kernel<8, kCluster>;
    case 16: return fps_reg_kernel<16, kCluster>;
    default: return nullptr;
  }
}

bool plan_ok(int cluster, int threads) {
  return cluster >= 1 && cluster <= kMaxCluster &&
         (cluster & (cluster - 1)) == 0 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

// Fills the launch configuration of a plan; returns the kernel or nullptr.
RegKernel configure(int cluster, int threads, int points, int b,
                    cudaStream_t stream, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr, cudaError_t* err) {
  *err = cudaErrorInvalidValue;
  if (!plan_ok(cluster, threads)) return nullptr;
  RegKernel kernel = cluster > 1 ? reg_kernel_for<true>(points)
                                 : reg_kernel_for<false>(points);
  if (kernel == nullptr) return nullptr;
  const size_t bytes = reg_smem_bytes(cluster, threads, points);
  *err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (*err != cudaSuccess) return nullptr;
  if (cluster > kPortableCluster) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (*err != cudaSuccess) return nullptr;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, b, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return kernel;
}

}  // namespace

extern "C" {

// How many clusters of `cluster` blocks (`threads` threads, `points`
// points a thread) the card holds at once; minus the cudaError_t on
// failure (a cluster size the card refuses gives 0 or an error).
int fps_max_clusters(int cluster, int threads, int points) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  RegKernel kernel =
      configure(cluster, threads, points, 1, nullptr, &cfg, &attr, &err);
  if (kernel == nullptr) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    return -(int)err;
  }
  return count;
}

// xyz: row b, point i, coordinate k at xyz[b*sb + i*sn + k] (float32).
// out: (b, npoint) int32, contiguous. A plan with cluster >= 1 runs the
// register kernel and needs cluster * threads * points >= n; cluster == 0
// runs the capacity kernel, which needs scratch, (b, n) float32. Returns
// the cudaError_t of the launch (0 on success).
int fps_launch(const float* xyz, long long sb, long long sn, int b, int n,
               int npoint, int cluster, int threads, int points, int* out,
               float* scratch, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || npoint <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    fps_capacity_kernel<<<b, 1024, 0, s>>>(xyz, sb, sn, n, npoint, out,
                                           scratch);
    return (int)cudaGetLastError();
  }
  if ((long long)cluster * threads * points < n)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  RegKernel kernel =
      configure(cluster, threads, points, b, s, &cfg, &attr, &err);
  if (kernel == nullptr) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, sb, sn, n, npoint, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
