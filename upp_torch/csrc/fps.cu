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
// of 16 blocks (16 SMs of one GPC; a non-portable cluster size), block r
// holding the points [r * NP, (r + 1) * NP) in shared memory and their
// running distances in registers (16 a thread, W <= 32 warps). A round
// reduces as the single-block kernel does within the block (warp keys,
// one barrier, warp 0 takes the block's key), and warp 0 publishes the
// block's key with the winner's x, y, z in a slot double-buffered by round
// parity; after one cluster barrier every warp reads the 16 slots through
// distributed shared memory and takes their maximum, which yields the next
// centre and its coordinates without a trip to device memory. The global
// index in the key's low word keeps the argmax exact across blocks: ties
// go to the lowest index, as in the plain version. The other design, a
// cooperative launch over every SM with a grid-wide barrier a round, would
// pay two round trips through L2 a round where the cluster barrier and the
// distributed shared memory stay within the GPC.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlockN = 16384;  // 12 bytes a point in shared memory: 192 KB
constexpr int kClusterBlocks = 16;  // blocks of one cloud in variant 6
constexpr int kClusterP = 16;       // points a thread in variant 6
constexpr int kClusterWarps = 32;   // warps a block at most in variant 6
constexpr int kMaxN = 262144;       // kClusterBlocks * kClusterWarps * 32 * kClusterP
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

// A block's candidate of one round in variant 6: its largest key and the
// coordinates of that point, read by the cluster's other blocks.
struct alignas(16) BlockBest {
  unsigned long long key;
  float x, y, z;
};

__device__ __forceinline__ unsigned long long pack_key(unsigned hi, unsigned lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Variant 6: the cloud blockIdx.x / kClusterBlocks over the cluster's 16
// blocks (see the head of this file). Block r's slot j is the point
// r * NP + j, NP = blockDim.x * kClusterP; thread t holds slots t + p * T,
// in index order with p.
__global__ void __launch_bounds__(kClusterWarps * 32)
fps_cluster_kernel(const float* __restrict__ xyz, const float* __restrict__ init, int N,
                   int S, int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long slot[2][kClusterWarps];
  __shared__ int first[2][kClusterWarps];
  __shared__ int block_first[2];        // read by the other blocks
  __shared__ BlockBest block_best[2];   // read by the other blocks, by round parity

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kClusterBlocks;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const int NP = T * kClusterP;
  const int base = rank * NP;               // global index of this block's slot 0
  const int n_here = max(0, min(NP, N - base));
  float* sx = smem;
  float* sy = sx + NP;
  float* sz = sy + NP;
  const float* pts = xyz + (size_t)b * N * 3;
  const float* in = init == nullptr ? nullptr : init + (size_t)b * N;

  for (int t = tid; t < 3 * n_here; t += T) {
    const int j = t / 3;
    smem[(t - 3 * j) * NP + j] = pts[3 * base + t];
  }
  for (int j = n_here + tid; j < NP; j += T) sx[j] = sy[j] = sz[j] = 0.f;

  float dist[kClusterP];
  int first_explicit = N, first_valid = N;
#pragma unroll
  for (int p = kClusterP - 1; p >= 0; --p) {  // downwards: the last hit is the lowest slot
    const int j = tid + p * T;
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
  cluster.sync();  // the staged points and every block's first slots
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

  int* out = idx_out + (size_t)b * S;
  for (int i = 0;; ++i) {
    if (rank == 0 && tid == 0) out[i] = cur;
    if (i + 1 == S) break;  // the last round's argmax is not needed
    float bv = -CUDART_INF_F;
    int bp = 0;
#pragma unroll
    for (int p = 0; p < kClusterP; ++p) {
      const int j = tid + p * T;
      const float dx = __fsub_rn(sx[j], cx);
      const float dy = __fsub_rn(sy[j], cy);
      const float dz = __fsub_rn(sz[j], cz);
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
    unsigned lo = ~static_cast<unsigned>(base + tid + bp * T);
    warp_max_key(hi, lo);
    if (lane == 0) slot[i & 1][warp] = pack_key(hi, lo);
    __syncthreads();
    if (warp == 0) {
      const unsigned long long k = lane < nwarps ? slot[i & 1][lane] : 0ull;
      hi = static_cast<unsigned>(k >> 32);
      lo = static_cast<unsigned>(k);
      warp_max_key(hi, lo);
      if (lane == 0) {
        const int j = static_cast<int>(~lo) - base;
        block_best[i & 1] = BlockBest{pack_key(hi, lo), sx[j], sy[j], sz[j]};
      }
    }
    // round i + 2 rewrites this parity's slot only after round i + 1's
    // barrier, which no block passes before every block has read it here
    cluster.sync();
    BlockBest c{0ull, 0.f, 0.f, 0.f};
    if (lane < kClusterBlocks) c = *cluster.map_shared_rank(&block_best[i & 1], lane);
    hi = static_cast<unsigned>(c.key >> 32);
    lo = static_cast<unsigned>(c.key);
    warp_max_key(hi, lo);
    const int win = __ffs(__ballot_sync(kFull, c.key == pack_key(hi, lo))) - 1;
    cx = __shfl_sync(kFull, c.x, win);
    cy = __shfl_sync(kFull, c.y, win);
    cz = __shfl_sync(kFull, c.z, win);
    cur = static_cast<int>(~lo);
  }
  cluster.sync();  // no block leaves while another may still read its slots
}

// Each kernel's dynamic shared memory limit is raised on each device once
// per kernel, device and size, the first time a launch needs more than is
// set, not on every call (beyond 48 KB, static included, a launch fails
// without it).
// Variant 6 also needs its non-portable cluster size allowed, once per
// device.
std::mutex g_smem_mutex;
int g_smem_limit[kNumVariants][kMaxDevices];
bool g_cluster_allowed[kMaxDevices];

cudaError_t reserve_smem(int v, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const void* kernel = v == kClusterVariant
                           ? reinterpret_cast<const void*>(fps_cluster_kernel)
                           : reinterpret_cast<const void*>(kVariants[v].kernel);
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (v == kClusterVariant && !g_cluster_allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_cluster_allowed[dev] = true;
  }
  if (g_smem_limit[v][dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) g_smem_limit[v][dev] = static_cast<int>(bytes);
  return err;
}

// Variant 6: a cluster of kClusterBlocks blocks per cloud, each block
// ceil(N / (kClusterBlocks * 32 * kClusterP)) warps (at most kClusterWarps).
int launch_cluster(const float* xyz, const float* init, int B, int N, int S, int* idx_out,
                   cudaStream_t stream) {
  const int per_warp = kClusterBlocks * 32 * kClusterP;
  const int warps = (N + per_warp - 1) / per_warp;
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(warps * 32 * kClusterP);
  cudaError_t err = reserve_smem(kClusterVariant, smem);
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
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, init, N, S, idx_out);
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
    return launch_cluster(xyz, init, B, N, S, idx_out, static_cast<cudaStream_t>(stream));
  const int P = kVariants[v].points_per_thread;
  const int warps = (N + 32 * P - 1) / (32 * P);
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(warps * 32 * P);
  const cudaError_t err = reserve_smem(v, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kVariants[v].kernel<<<B, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, init, N, S, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
