// Furthest point sampling on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel upp_tpu/ops/fps_pallas.py::_fps_kernel
// (reached through fps_pallas_idx / fps_pallas).
//
// What it computes: for each cloud b, n_samples indices chosen one after the
// other; each round takes the point whose running minimum squared distance to
// the chosen set is largest (ties to the lowest index). Validity and the
// explicit start come encoded in `init` exactly as the Pallas kernel takes
// them: 1e10 for a valid slot, -1 for an invalid one (d >= 0 keeps it at -1,
// so it is never chosen and never shrinks a distance), 2e10 for the explicit
// start. Without a 2e10 slot the start is the first valid slot. A null
// `init` means every slot valid and the start at slot 0.
//
// Bound on this card: latency and instruction rate. The S rounds depend on
// each other; what bytes and operations the function needs (one read of
// xyz, ~10 flops per point and round) would take well under a millisecond
// at the card's peak, but each round ends in a block-wide argmax that every
// thread waits for.
//
// Design: one thread block per cloud, nothing back to device memory between
// rounds. Each thread owns P points (P a template parameter chosen from N,
// slots j = tid + p * blockDim, so a thread visits its points in index
// order) and keeps their x, y, z and running distance in registers. At 4
// registers a point, 32 points take 128 registers a thread, which caps the
// block at 8 warps and 8192 points; beyond, the coordinates stay in shared
// memory and only the distances in registers. A round reads only the chosen
// centre from shared memory, where the cloud is also staged. Its argmax is
// the maximum of one 64-bit key per candidate: order-preserving bits of the
// running distance (the -1 of invalid slots included) in the high word, the
// complement of the index in the low word, so the largest key is the
// largest distance at the lowest index. A warp takes that maximum with two
// redux.sync instructions (the high word's max, then the low word's max
// among the lanes that hold it; shorter than a five-step shuffle butterfly
// on the 64-bit key), writes its key into a slot array double-buffered by
// round parity, and after the round's only barrier every warp reduces the
// slots itself. A round therefore has one barrier and no second one to
// broadcast the winner; the buffer a warp writes in round i + 1 is not the
// one a slower warp may still read from round i, and round i + 2's writes
// wait behind round i + 1's barrier. The squared distance is
// (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics and no
// multiply-add contraction, the arithmetic of the plain PyTorch version, so
// both pick identical indices over all S dependent rounds.
//
// Variants (points per thread P, warps W = ceil(N / (32 P)) <= 16):
//   N <= 32: P = 1; <= 64: 2; <= 2048: 4; <= 4096: 8; <= 8192: 32 (these with
//   x, y, z in registers); <= 16384: 32 with x, y, z in shared memory.
//
// Variant 6, 16384 < N <= 2^18 (the patch denoiser's re-sampling of about
// 3N points, utils/denoise.py): one cloud does not fit one SM's shared
// memory, and a block per cloud would leave 131 of the 132 SMs idle at the
// denoiser's batch of 1. So a cloud is spread over a thread-block cluster
// of 16 blocks (16 SMs of one GPC; a non-portable cluster size). Block r
// holds the points [r * NP, (r + 1) * NP), NP = W * 32 * P; each of its W
// warps holds a contiguous run of 32 P of them, lane l the run's points
// l + 32 p, so a thread's points come in index order with p. The rounds
// depend on each other, so a round's latency is the kernel's time, and the
// design takes the three things that set it:
//
// 1. A one-way exchange on mbarriers. A round reduces within the block as
//    the single-block kernel does (warp keys, one __syncthreads), then warp
//    0 takes the block's key and its lanes 0-15 push it, with the winner's
//    x, y, z, to the 16 blocks: lane q writes slot [i & 1][r] of block q's
//    shared memory by st.async, which completes its bytes on block q's
//    mbarrier of parity i & 1. Every warp then waits on its own block's
//    mbarrier of that parity and reduces the 16 local slots, which gives the
//    next centre and its coordinates. A round thus has one __syncthreads,
//    one one-way signal, no cluster-wide barrier and no remote load on the
//    reading side. Thread 0 arms each mbarrier phase with the bytes it
//    expects (16 pushes of kCandidateBytes) right after it has seen the
//    phase before complete.
//    The double buffer is safe. A block reaches round i + 2's push into slot
//    [i & 1] only after it has received every peer's round i + 1 push. A
//    peer sends that push only after all of its warps have passed round
//    i + 1's __syncthreads, and a warp gets there only after it has read
//    round i's slots. So no slot is overwritten while a warp may still read
//    it, no phase of an mbarrier completes while a warp still waits on the
//    phase two before it, and thread 0's arming of round i + 2 (done before
//    its block's round i + 1 push) precedes every push of round i + 2. A
//    block's last incoming pushes (round S - 2) land before it passes round
//    S - 1; the cluster barrier at the end keeps each block resident until
//    the others have also read its start slots.
// 2. Coordinates in registers where they fit. Up to kClusterBlocks * 20 *
//    32 * 16 = 163840 points a thread keeps x, y, z and the running distance
//    of its P points in registers, 4 a point as in variants 0-4 (P = 8 in at
//    most 16 warps up to 65536 points, P = 16 in at most 20 warps beyond);
//    the block's copy of the points in shared memory then only gives the
//    block winner's coordinates. Past that, up to 2^18, x, y, z stay in
//    shared memory (P = 16 in at most 32 warps). The shapes were chosen by
//    timing them in turns at the denoiser's shapes on the H100
//    (scripts/torch_kernel_variants.py fps-cluster): at 150000 points 20
//    warps of 16 beat 13 of 24 and 12 of 32.
// 3. Exact warp-level skipping. Each warp keeps its run's box (the least and
//    largest x, y, z of its points that can still be chosen), its largest
//    running distance and its best key (the former is the latter's high
//    word). A round first tests lb, the squared distance of the centre c to
//    the box: clamp(c, box_min, box_max) - c, squared and summed in the same
//    rounded arithmetic as a point's distance (the lanes that read the 16
//    candidates compute it for theirs beside the argmax, and it comes from
//    the winner's lane with the coordinates). Round-to-nearest subtraction, squaring and addition
//    are monotone, so lb is at most the computed distance of every point in
//    the box. If lb >= the warp's largest running distance, fminf(dist, d)
//    could change none of them, and the warp offers its kept key without
//    touching its points. Invalid slots (-1) and padding (-inf) never change
//    either. The denoiser's input is 150 patches of 1000 nearest neighbours
//    laid end to end, so a run is spatially tight and, once the running
//    distances have shrunk, most warps skip most rounds; on a cloud in random
//    order every box is the cloud's own and no warp skips.
// The global index in the key's low word keeps the argmax exact across warps
// and blocks: ties go to the lowest index, as in the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlockN = 16384;  // 12 bytes a point in shared memory: 192 KB
constexpr int kClusterBlocks = 16;  // blocks of one cloud in variant 6
constexpr int kMaxN = 262144;       // kClusterBlocks * 32 warps * 32 * 16 points a thread
constexpr int kMaxWarps = 16;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e10f;

// Float bits that order like the value, negatives included.
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ ((u >> 31) ? kFull : 0x80000000u);
}

// The warp's largest (hi, lo) key, in every lane.
__device__ __forceinline__ void warp_max_key(unsigned& hi, unsigned& lo) {
  const unsigned m = __reduce_max_sync(kFull, hi);
  lo = __reduce_max_sync(kFull, hi == m ? lo : 0u);
  hi = m;
}

// 32 points of x, y, z and distance take 128 registers a thread: that
// variant runs at most 8 warps (the register file holds 65536)
template <int P, bool kXyzInRegisters>
__global__ void __launch_bounds__(kXyzInRegisters && P >= 32 ? 256 : kMaxWarps * 32)
fps_kernel(const float* __restrict__ xyz, const float* __restrict__ init, int N, int S,
           int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long slot[2][kMaxWarps];
  __shared__ int first[2][kMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const int NP = T * P;  // slots, N of them real; the rest -inf and never chosen
  float* sx = smem;
  float* sy = sx + NP;
  float* sz = sy + NP;
  const float* pts = xyz + (size_t)b * N * 3;
  const float* in = init == nullptr ? nullptr : init + (size_t)b * N;

  for (int t = tid; t < 3 * N; t += T) {
    const int j = t / 3;
    smem[(t - 3 * j) * NP + j] = pts[t];
  }
  for (int j = N + tid; j < NP; j += T) sx[j] = sy[j] = sz[j] = 0.f;

  float dist[P];
  int first_explicit = N, first_valid = N;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {  // downwards: the last hit is the lowest slot
    const int j = tid + p * T;
    float v = -CUDART_INF_F;
    if (j < N) {
      v = in == nullptr ? kBig : in[j];
      if (v > 1.5f * kBig) first_explicit = j;
      if (v > 0.f) first_valid = j;
    }
    dist[p] = v;
  }
  first_explicit = __reduce_min_sync(kFull, first_explicit);
  first_valid = __reduce_min_sync(kFull, first_valid);
  if (lane == 0) {
    first[0][warp] = first_explicit;
    first[1][warp] = first_valid;
  }
  __syncthreads();

  float x[kXyzInRegisters ? P : 1], y[kXyzInRegisters ? P : 1], z[kXyzInRegisters ? P : 1];
  if constexpr (kXyzInRegisters) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      x[p] = sx[tid + p * T];
      y[p] = sy[tid + p * T];
      z[p] = sz[tid + p * T];
    }
  }
  first_explicit = __reduce_min_sync(kFull, lane < nwarps ? first[0][lane] : N);
  first_valid = __reduce_min_sync(kFull, lane < nwarps ? first[1][lane] : N);
  int cur = first_explicit < N ? first_explicit : (first_valid < N ? first_valid : 0);

  int* out = idx_out + (size_t)b * S;
  for (int i = 0;; ++i) {
    if (tid == 0) out[i] = cur;
    if (i + 1 == S) break;  // the last round's argmax is not needed
    const float cx = sx[cur], cy = sy[cur], cz = sz[cur];
    float bv = -CUDART_INF_F;
    int bp = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float px, py, pz;
      if constexpr (kXyzInRegisters) {
        px = x[p];
        py = y[p];
        pz = z[p];
      } else {
        px = sx[tid + p * T];
        py = sy[tid + p * T];
        pz = sz[tid + p * T];
      }
      const float dx = __fsub_rn(px, cx);
      const float dy = __fsub_rn(py, cy);
      const float dz = __fsub_rn(pz, cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float nd = fminf(dist[p], d);
      dist[p] = nd;
      if (nd > bv) {  // strict: the thread's slots come in index order
        bv = nd;
        bp = p;
      }
    }
    unsigned hi = ordered_bits(bv);
    unsigned lo = ~static_cast<unsigned>(tid + bp * T);
    warp_max_key(hi, lo);
    if (lane == 0) slot[i & 1][warp] = (static_cast<unsigned long long>(hi) << 32) | lo;
    __syncthreads();
    const unsigned long long k = lane < nwarps ? slot[i & 1][lane] : 0ull;
    hi = static_cast<unsigned>(k >> 32);
    lo = static_cast<unsigned>(k);
    warp_max_key(hi, lo);
    cur = static_cast<int>(~lo);
  }
}

using FpsKernel = void (*)(const float*, const float*, int, int, int*);

struct Variant {
  FpsKernel kernel;
  int points_per_thread;
  int max_n;
};

// In order of N; the first whose max_n >= N serves it, in ceil(N / (32 P))
// warps. The shapes were chosen by timing P and the warp count at the path's
// shapes on the H100 (scripts/torch_kernel_variants.py): at N ~ 1000 ten
// warps of 4 points beat five of 8; at N = 8192 eight warps of 32 beat
// sixteen of 16.
const Variant kVariants[] = {
    {fps_kernel<1, true>, 1, 32},     {fps_kernel<2, true>, 2, 64},
    {fps_kernel<4, true>, 4, 2048},   {fps_kernel<8, true>, 8, 4096},
    {fps_kernel<32, true>, 32, 8192}, {fps_kernel<32, false>, 32, kMaxBlockN},
};
constexpr int kNumBlockVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kClusterVariant = kNumBlockVariants;  // variant 6
constexpr int kNumVariants = kNumBlockVariants + 1;

int variant_of(int N) {
  for (int v = 0; v < kNumBlockVariants; ++v)
    if (N <= kVariants[v].max_n) return v;
  return N <= kMaxN ? kClusterVariant : -1;
}

// A block's candidate of one round in variant 6: its largest key (low and
// high word) and the coordinates of that point; its first kCandidateBytes
// are pushed into every block of the cluster.
struct alignas(16) Candidate {
  unsigned lo, hi;
  float x, y, z;
};
constexpr unsigned kCandidateBytes = 20;
constexpr unsigned kRoundBytes = kClusterBlocks * kCandidateBytes;  // a phase's bytes

__device__ __forceinline__ unsigned long long pack_key(unsigned hi, unsigned lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Arms the mbarrier's current phase: one arrival (its whole count) and the
// bytes of one round's 16 pushes.
__device__ __forceinline__ void expect_round(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(smem_addr(bar)), "r"(kRoundBytes) : "memory");
}

__device__ __forceinline__ void wait_round(unsigned long long* bar, int parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// Writes c into `slot` of block `rank`, completing its bytes on that
// block's `bar`.
__device__ __forceinline__ void push_candidate(Candidate* slot, unsigned long long* bar,
                                               int rank, const Candidate& c) {
  const unsigned dst = peer_addr(smem_addr(slot), rank);
  const unsigned mbar = peer_addr(smem_addr(bar), rank);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(c.lo), "r"(c.hi), "r"(__float_as_uint(c.x)), "r"(__float_as_uint(c.y)),
         "r"(mbar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(dst + 16), "r"(__float_as_uint(c.z)), "r"(mbar) : "memory");
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

// (dx*dx + dy*dy) + dz*dz, one rounded operation at a time.
__device__ __forceinline__ float sq_dist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Variant 6: the cloud blockIdx.x / kClusterBlocks over the cluster's 16
// blocks (see the head of this file): P points a thread, at most kWarps
// warps a block, x, y, z in registers or in shared memory. With `stats`,
// each warp that holds points that can be chosen adds its skipped rounds to
// stats[0] and its rounds to stats[1].
template <int P, int kWarps, bool kXyzInRegisters>
__global__ void __launch_bounds__(kWarps * 32)
fps_cluster_kernel(const float* __restrict__ xyz, const float* __restrict__ init, int N,
                   int S, int* __restrict__ idx_out, unsigned long long* __restrict__ stats) {
  extern __shared__ float smem[];
  __shared__ unsigned long long slot[2][kWarps];
  __shared__ int first[2][kWarps];
  __shared__ int block_first[2];                   // read by the other blocks
  __shared__ Candidate cand[2][kClusterBlocks];   // written by the other blocks
  __shared__ unsigned long long bar[2];           // their mbarriers, by round parity

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kClusterBlocks;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const int NP = T * P;
  const int base = rank * NP;             // global index of this block's slot 0
  const int run = warp * 32 * P + lane;   // this thread's slot p is run + 32 p
  const int n_here = max(0, min(NP, N - base));
  float* sx = smem;
  float* sy = sx + NP;
  float* sz = sy + NP;
  const float* pts = xyz + (size_t)b * N * 3;
  const float* in = init == nullptr ? nullptr : init + (size_t)b * N;

  if (tid == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bar[p])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    expect_round(&bar[0]);  // round 0
    expect_round(&bar[1]);  // round 1
  }
  for (int t = tid; t < 3 * n_here; t += T) {
    const int j = t / 3;
    smem[(t - 3 * j) * NP + j] = pts[3 * base + t];
  }
  for (int j = n_here + tid; j < NP; j += T) sx[j] = sy[j] = sz[j] = 0.f;

  float dist[P];
  int first_explicit = N, first_valid = N;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {  // downwards: the last hit is the lowest slot
    const int j = run + 32 * p;
    float v = -CUDART_INF_F;
    if (j < n_here) {
      v = in == nullptr ? kBig : in[base + j];
      if (v > 1.5f * kBig) first_explicit = base + j;
      if (v > 0.f) first_valid = base + j;
    }
    dist[p] = v;
  }
  first_explicit = __reduce_min_sync(kFull, first_explicit);
  first_valid = __reduce_min_sync(kFull, first_valid);
  if (lane == 0) {
    first[0][warp] = first_explicit;
    first[1][warp] = first_valid;
  }
  __syncthreads();
  if (warp == 0) {
    first_explicit = __reduce_min_sync(kFull, lane < nwarps ? first[0][lane] : N);
    first_valid = __reduce_min_sync(kFull, lane < nwarps ? first[1][lane] : N);
    if (lane == 0) {
      block_first[0] = first_explicit;
      block_first[1] = first_valid;
    }
  }

  float x[kXyzInRegisters ? P : 1], y[kXyzInRegisters ? P : 1], z[kXyzInRegisters ? P : 1];
  if constexpr (kXyzInRegisters) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      x[p] = sx[run + 32 * p];
      y[p] = sy[run + 32 * p];
      z[p] = sz[run + 32 * p];
    }
  }
  // the warp's box over its points that can be chosen (distance >= 0), and
  // its key over the initial distances
  float lo_x = CUDART_INF_F, lo_y = CUDART_INF_F, lo_z = CUDART_INF_F;
  float hi_x = -CUDART_INF_F, hi_y = -CUDART_INF_F, hi_z = -CUDART_INF_F;
  float bv = -CUDART_INF_F;
  int bp = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float px, py, pz;
    if constexpr (kXyzInRegisters) {
      px = x[p];
      py = y[p];
      pz = z[p];
    } else {
      px = sx[run + 32 * p];
      py = sy[run + 32 * p];
      pz = sz[run + 32 * p];
    }
    if (dist[p] >= 0.f) {
      lo_x = fminf(lo_x, px);
      lo_y = fminf(lo_y, py);
      lo_z = fminf(lo_z, pz);
      hi_x = fmaxf(hi_x, px);
      hi_y = fmaxf(hi_y, py);
      hi_z = fmaxf(hi_z, pz);
    }
    if (dist[p] > bv) {
      bv = dist[p];
      bp = p;
    }
  }
  lo_x = warp_min(lo_x);
  lo_y = warp_min(lo_y);
  lo_z = warp_min(lo_z);
  hi_x = warp_max(hi_x);
  hi_y = warp_max(hi_y);
  hi_z = warp_max(hi_z);
  unsigned whi = ordered_bits(bv);  // the warp's key: its largest running distance
  unsigned wlo = ~static_cast<unsigned>(base + run + 32 * bp);
  warp_max_key(whi, wlo);
  // lb: the squared distance of a centre to the warp's box, in the rounding
  // of a point's distance; >= +0, so its ordered bits are its own bits with
  // the sign bit set
  auto box_bound = [&](float px, float py, float pz) {
    return sq_dist(__fsub_rn(fminf(fmaxf(px, lo_x), hi_x), px),
                   __fsub_rn(fminf(fmaxf(py, lo_y), hi_y), py),
                   __fsub_rn(fminf(fmaxf(pz, lo_z), hi_z), pz));
  };

  cluster.sync();  // the staged points, every block's first slots and mbarriers
  first_explicit = N;
  first_valid = N;
  if (lane < kClusterBlocks) {
    const int* remote = cluster.map_shared_rank(block_first, lane);
    first_explicit = remote[0];
    first_valid = remote[1];
  }
  first_explicit = __reduce_min_sync(kFull, first_explicit);
  first_valid = __reduce_min_sync(kFull, first_valid);
  int cur = first_explicit < N ? first_explicit : (first_valid < N ? first_valid : 0);
  float cx = pts[3 * cur], cy = pts[3 * cur + 1], cz = pts[3 * cur + 2];
  float lb = box_bound(cx, cy, cz);

  unsigned skipped = 0;
  int* out = idx_out + (size_t)b * S;
  for (int i = 0;; ++i) {
    if (rank == 0 && tid == 0) out[i] = cur;
    if (i + 1 == S) break;  // the last round's argmax is not needed
    // warp-uniform; else lb >= the run's largest distance: none can shrink
    if ((__float_as_uint(lb) | 0x80000000u) < whi) {
      bv = -CUDART_INF_F;
      bp = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float px, py, pz;
        if constexpr (kXyzInRegisters) {
          px = x[p];
          py = y[p];
          pz = z[p];
        } else {
          px = sx[run + 32 * p];
          py = sy[run + 32 * p];
          pz = sz[run + 32 * p];
        }
        const float nd =
            fminf(dist[p], sq_dist(__fsub_rn(px, cx), __fsub_rn(py, cy), __fsub_rn(pz, cz)));
        dist[p] = nd;
        if (nd > bv) {  // strict: the thread's slots come in index order
          bv = nd;
          bp = p;
        }
      }
      whi = ordered_bits(bv);
      wlo = ~static_cast<unsigned>(base + run + 32 * bp);
      warp_max_key(whi, wlo);
    } else {
      ++skipped;
    }
    if (lane == 0) slot[i & 1][warp] = pack_key(whi, wlo);
    __syncthreads();
    if (warp == 0) {
      const unsigned long long k = lane < nwarps ? slot[i & 1][lane] : 0ull;
      unsigned hi = static_cast<unsigned>(k >> 32);
      unsigned lo = static_cast<unsigned>(k);
      warp_max_key(hi, lo);
      if (lane < kClusterBlocks) {
        const int j = static_cast<int>(~lo) - base;
        push_candidate(&cand[i & 1][rank], &bar[i & 1], lane,
                       Candidate{lo, hi, sx[j], sy[j], sz[j]});
      }
    }
    wait_round(&bar[i & 1], (i >> 1) & 1);
    if (tid == 0) expect_round(&bar[i & 1]);  // its next phase: round i + 2
    Candidate c{0u, 0u, 0.f, 0.f, 0.f};
    if (lane < kClusterBlocks) c = cand[i & 1][lane];
    const float lb_c = box_bound(c.x, c.y, c.z);  // each lane its candidate's, beside the argmax
    unsigned hi = c.hi;
    unsigned lo = c.lo;
    warp_max_key(hi, lo);
    const int win = __ffs(__ballot_sync(kFull, c.hi == hi && c.lo == lo)) - 1;
    cx = __shfl_sync(kFull, c.x, win);
    cy = __shfl_sync(kFull, c.y, win);
    cz = __shfl_sync(kFull, c.z, win);
    lb = __shfl_sync(kFull, lb_c, win);
    cur = static_cast<int>(~lo);
  }
  if (stats != nullptr && lane == 0 && lo_x <= hi_x) {  // warps that hold points
    atomicAdd(stats, static_cast<unsigned long long>(skipped));
    atomicAdd(stats + 1, static_cast<unsigned long long>(S - 1));
  }
  cluster.sync();  // no block leaves while another may still read its start slots
}

using FpsClusterKernel = void (*)(const float*, const float*, int, int, int*,
                                  unsigned long long*);

struct ClusterShape {
  FpsClusterKernel kernel;
  int points_per_thread;
  int max_warps;
  bool xyz_in_registers;
};

// Variant 6's instances, in order of N: the first that holds N points in
// kClusterBlocks blocks of max_warps warps serves it, in ceil(N /
// (kClusterBlocks * 32 P)) warps a block. 4P registers of points a thread
// and the rest of the round fit the register file at these warp counts.
const ClusterShape kClusterShapes[] = {
    {fps_cluster_kernel<8, 16, true>, 8, 16, true},      // N <= 65536
    {fps_cluster_kernel<16, 20, true>, 16, 20, true},    // N <= 163840
    {fps_cluster_kernel<16, 32, false>, 16, 32, false},  // N <= kMaxN
};
constexpr int kNumClusterShapes = sizeof(kClusterShapes) / sizeof(kClusterShapes[0]);

int cluster_shape_of(int N) {
  if (N <= kMaxBlockN || N > kMaxN) return -1;
  for (int c = 0; c < kNumClusterShapes; ++c)
    if (N <= kClusterBlocks * 32 * kClusterShapes[c].points_per_thread *
                 kClusterShapes[c].max_warps)
      return c;
  return -1;
}

// Each kernel's dynamic shared memory limit is raised on each device once
// per kernel, device and size, the first time a launch needs more than is
// set, not on every call (beyond 48 KB, static included, a launch fails
// without it). Slots 0-5 are variants 0-5, the rest variant 6's instances,
// which also need their non-portable cluster size allowed, once per device.
constexpr int kNumKernels = kNumBlockVariants + kNumClusterShapes;
std::mutex g_smem_mutex;
int g_smem_limit[kNumKernels][kMaxDevices];
bool g_cluster_allowed[kNumKernels][kMaxDevices];

cudaError_t reserve_smem(int v, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const bool cluster = v >= kNumBlockVariants;
  const void* kernel =
      cluster ? reinterpret_cast<const void*>(kClusterShapes[v - kNumBlockVariants].kernel)
              : reinterpret_cast<const void*>(kVariants[v].kernel);
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (cluster && !g_cluster_allowed[v][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_cluster_allowed[v][dev] = true;
  }
  if (g_smem_limit[v][dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) g_smem_limit[v][dev] = static_cast<int>(bytes);
  return err;
}

// Variant 6: a cluster of kClusterBlocks blocks per cloud.
int launch_cluster(const float* xyz, const float* init, int B, int N, int S, int* idx_out,
                   unsigned long long* stats, cudaStream_t stream) {
  const int c = cluster_shape_of(N);
  if (c < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterShape& shape = kClusterShapes[c];
  const int per_warp = kClusterBlocks * 32 * shape.points_per_thread;
  const int warps = (N + per_warp - 1) / per_warp;
  const size_t smem =
      sizeof(float) * 3 * static_cast<size_t>(warps * 32 * shape.points_per_thread);
  cudaError_t err = reserve_smem(kNumBlockVariants + c, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks * B);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, shape.kernel, xyz, init, N, S, idx_out, stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int upp_fps_max_n() { return kMaxN; }

int upp_fps_num_variants() { return kNumVariants; }

// Index in kVariants of the variant that serves clouds of N points (-1 if
// none does).
int upp_fps_variant(int N) { return N > 0 ? variant_of(N) : -1; }

const char* upp_fps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xyz [B, N, 3] f32, init [B, N] f32 or null, idx_out [B, S] i32, all
// contiguous on the current device. Launches on `stream`; returns the CUDA
// error code.
int upp_fps(const float* xyz, const float* init, int B, int N, int S,
            int* idx_out, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const int v = N > 0 ? variant_of(N) : -1;
  if (v < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (v == kClusterVariant)
    return launch_cluster(xyz, init, B, N, S, idx_out, nullptr,
                          static_cast<cudaStream_t>(stream));
  const int P = kVariants[v].points_per_thread;
  const int warps = (N + 32 * P - 1) / (32 * P);
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(warps * 32 * P);
  const cudaError_t err = reserve_smem(v, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kVariants[v].kernel<<<B, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, init, N, S, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// Variant 6's instance for N: points a thread, warps a block, x, y, z in
// registers (1) or in shared memory (0). Returns -1 if variant 6 does not
// serve N.
int upp_fps_cluster_shape(int N, int* points_per_thread, int* warps, int* in_registers) {
  const int c = cluster_shape_of(N);
  if (c < 0) return -1;
  const int P = kClusterShapes[c].points_per_thread;
  *points_per_thread = P;
  *warps = (N + kClusterBlocks * 32 * P - 1) / (kClusterBlocks * 32 * P);
  *in_registers = kClusterShapes[c].xyz_in_registers ? 1 : 0;
  return 0;
}

// upp_fps for variant 6 (N > 16384) that also adds, over the warps that
// hold points that can be chosen, the rounds a warp skipped to stats[0] and
// all their rounds to stats[1] (stats: 2 u64 on the device).
int upp_fps_cluster_stats(const float* xyz, const float* init, int B, int N, int S,
                          int* idx_out, unsigned long long* stats, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  return launch_cluster(xyz, init, B, N, S, idx_out, stats, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
