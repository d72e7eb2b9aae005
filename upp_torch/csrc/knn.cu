// k-nearest-neighbour search (with optional neighbour gather) on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel upp_tpu/ops/knn_pallas.py::_knn_kernel
// (reached through _knn_gather_fwd_impl -> knn_gather / knn_idx). Forward
// only: the backward pass is plain tensor code (ops/knn.py::KnnKernel).
//
// What it computes: for each query, the k points of its cloud with the
// smallest squared distance, ascending, ties to the lowest index (the
// Pallas kernel's k rounds of rowwise min with lowest-index argmin, and the
// stable sort of the plain PyTorch version). Distances use the difference
// form ((qx-px)^2 + (qy-py)^2) + (qz-pz)^2 like the Pallas kernel, one
// round-to-nearest op at a time and no multiply-add contraction: the plain
// version does the same arithmetic, so both agree bit for bit. With `nbr`
// non-null it also writes the neighbours' xyz.
//
// Bound on this card: the S*N distance evaluations (9 flops each) and the
// selection, which must be spread over enough warps to fill the SMs (a
// cloud has only 32-64 queries on most call sites); the bytes (each point
// and query read once, k outputs per query) are small.
//
// Design: a warp per query, 8 warps per block; where S is large, fewer
// blocks whose warps take several queries each. The block stages its cloud
// once in shared memory (structure of arrays, a coalesced flat copy); the
// warp's 32 lanes take the points in chunks of 32, one point a lane. Each
// (distance, index) pair is one 64-bit key: the float bits of d (d >= +0,
// so its bits order like its value) in the high word, the point index in
// the low word. Keys are unique, and the k smallest keys in ascending order
// are exactly the stable-sort result, whatever order they are found in. The
// warp keeps the 32 smallest keys merged so far, one per lane in ascending
// order, and their k-th as the threshold: a key at or above it cannot be
// among the k smallest. A chunk whose keys all lie above the threshold costs
// one ballot; the others append their candidates to a 32-slot buffer of the
// warp in shared memory (ballot and popc give each its slot). When a chunk's
// candidates would overflow the buffer, and at the end, the buffer is sorted
// by a warp bitonic sort, reversed and merged into the kept keys by an
// elementwise min and a bitonic merge (shuffles only), and the threshold is
// renewed; so a merge serves up to 32 candidates instead of one chunk's
// few. Lanes 0..k-1 then write d, idx and the gathered xyz, coalesced.
//
// k in 33..64 (AdaPoinTr's fold decoder asks for 64) keeps two keys a lane,
// the template's KEYS = 2: the 64 smallest merged so far, ascending, lane m
// holding key m in `best` and key 32 + m in `best_hi`; the threshold is the
// k-th of the 64. A flush merges the sorted buffer into both halves: the
// elementwise min and max of `best` and the reversed buffer are bitonic and
// hold the 32 smallest and the 32 largest of their union, so `best` is the
// first cleaned, and `best_hi` the 32 smallest of the old `best_hi` and the
// second (a warp_merge). The cloud is still read once, and a second pass
// over it (the other way to serve k > 32, restarting above the kept 32th
// key) would evaluate every distance twice. KEYS = 1 is the k <= 32 kernel
// of every other call site, unchanged.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kMaxK = 64;   // two kept keys a lane of the query's warp
constexpr int kMaxN = 16384;  // 12 bytes a point: 192 KB of shared memory
constexpr int kWarps = 8;     // warps per block, one query at a time each
constexpr int kMaxBlocks = 2048;  // about two waves of 8 resident blocks on 132 SMs
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;  // above every (distance, index) key

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? b : a;
}

// Bitonic sort of one key per lane, ascending with the lane.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_min ? umin64(v, o) : umax64(v, o);
    }
  }
  return v;
}

// A bitonic sequence, one key per lane, sorted ascending with the lane.
__device__ __forceinline__ unsigned long long warp_clean(unsigned long long v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
    v = (lane & stride) ? umax64(v, o) : umin64(v, o);
  }
  return v;
}

// The 32 smallest of two ascending warp sequences, ascending: the
// elementwise min of `q` and reversed `c` is bitonic and holds them.
__device__ __forceinline__ unsigned long long warp_merge(unsigned long long q,
                                                         unsigned long long c, int lane) {
  return warp_clean(umin64(q, __shfl_sync(kFull, c, 31 - lane)), lane);
}

template <int KEYS>
__global__ void __launch_bounds__(kWarps * 32)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points, int S,
           int N, int K, float* __restrict__ d_out, int* __restrict__ idx_out,
           float* __restrict__ nbr_out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long pending_keys[kWarps][32];
  float* px = smem;
  float* py = px + N;
  float* pz = py + N;
  const int b = blockIdx.y;
  const float* pb = points + (size_t)b * N * 3;
  for (int t = threadIdx.x; t < 3 * N; t += blockDim.x) {
    const int j = t / 3;
    smem[(t - 3 * j) * N + j] = pb[t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned long long* pending = pending_keys[threadIdx.x >> 5];
  for (int s = blockIdx.x * warps + (threadIdx.x >> 5); s < S; s += gridDim.x * warps) {
    const size_t row = (size_t)b * S + s;
    const float qx = query[3 * row], qy = query[3 * row + 1], qz = query[3 * row + 2];

    unsigned long long best = kNone;   // lane m: the m-th smallest key merged
    unsigned long long best_hi = kNone;  // KEYS == 2: lane m, the (32 + m)-th
    unsigned long long worst = kNone;  // the K-th smallest key merged
    int count = 0;                     // candidates pending, the same in every lane
    bool merged = false;               // whether `best` holds any key yet
    // merge the pending candidates into `best`: sort them, merge, new threshold
    auto flush = [&]() {
      __syncwarp();  // the lanes' pending writes are visible
      const unsigned long long c = lane < count ? pending[lane] : kNone;
      __syncwarp();  // read before a lane writes again
      const unsigned long long sorted = warp_sort(c, lane);
      if (KEYS == 1) {
        best = merged ? warp_merge(best, sorted, lane) : sorted;
        worst = __shfl_sync(kFull, best, K - 1);
      } else {
        if (merged) {
          const unsigned long long r = __shfl_sync(kFull, sorted, 31 - lane);
          const unsigned long long upper = warp_clean(umax64(best, r), lane);
          best = warp_clean(umin64(best, r), lane);
          best_hi = warp_merge(best_hi, upper, lane);
        } else {
          best = sorted;
        }
        worst = __shfl_sync(kFull, K > 32 ? best_hi : best, (K - 1) & 31);
      }
      count = 0;
      merged = true;
    };
    for (int base = 0; base < N; base += 32) {
      const int j = base + lane;
      unsigned long long key = kNone;
      if (j < N) {
        const float dx = __fsub_rn(qx, px[j]);
        const float dy = __fsub_rn(qy, py[j]);
        const float dz = __fsub_rn(qz, pz[j]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        key = (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
              static_cast<unsigned>(j);
      }
      // a key at or above the k-th merged one cannot be among the k smallest
      bool cand = key < worst;
      unsigned mask = __ballot_sync(kFull, cand);
      if (mask == 0u) continue;
      if (count + __popc(mask) > 32) {
        flush();
        cand = key < worst;
        mask = __ballot_sync(kFull, cand);
      }
      if (cand) pending[count + __popc(mask & lanes_below)] = key;
      count += __popc(mask);
    }
    if (count > 0) flush();

#pragma unroll
    for (int h = 0; h < KEYS; ++h) {
      const int m = 32 * h + lane;
      if (m < K) {
        const unsigned long long key = h == 0 ? best : best_hi;
        const int j = static_cast<int>(key & 0xffffffffu);
        const size_t o = row * K + m;
        d_out[o] = __uint_as_float(static_cast<unsigned>(key >> 32));
        idx_out[o] = j;
        if (nbr_out != nullptr) {
          nbr_out[3 * o] = px[j];
          nbr_out[3 * o + 1] = py[j];
          nbr_out[3 * o + 2] = pz[j];
        }
      }
    }
  }
}

// Each kernel's dynamic shared memory limit is raised on each device once
// per device and size, the first time a launch needs more than is set, not
// on every call (beyond 48 KB a launch fails without it).
std::mutex g_smem_mutex;
int g_smem_limit[2][kMaxDevices];

template <int KEYS>
cudaError_t reserve_smem(size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  int& limit = g_smem_limit[KEYS - 1][dev];
  if (limit >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(knn_kernel<KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) limit = static_cast<int>(bytes);
  return err;
}

template <int KEYS>
int launch(const float* query, const float* points, int B, int S, int N, int K,
           float* d_out, int* idx_out, float* nbr_out, cudaStream_t stream) {
  const int warps = min(kWarps, S);
  // a block per (cloud, 8 queries), or fewer blocks whose warps take several
  // queries each where that would exceed kMaxBlocks
  const dim3 grid(min((S + warps - 1) / warps, max(1, kMaxBlocks / B)), B);
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(N);
  const cudaError_t err = reserve_smem<KEYS>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_kernel<KEYS><<<grid, warps * 32, smem, stream>>>(query, points, S, N, K, d_out,
                                                        idx_out, nbr_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int upp_knn_max_k() { return kMaxK; }

int upp_knn_max_n() { return kMaxN; }

const char* upp_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// query [B, S, 3] f32, points [B, N, 3] f32, d_out [B, S, K] f32,
// idx_out [B, S, K] i32, nbr_out [B, S, K, 3] f32 or null; all contiguous on
// the current device. Launches on `stream`; returns the CUDA error code.
int upp_knn(const float* query, const float* points, int B, int S, int N, int K,
            float* d_out, int* idx_out, float* nbr_out, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (N <= 0 || N > kMaxN || K <= 0 || K > kMaxK || K > N || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K <= 32 ? launch<1>(query, points, B, S, N, K, d_out, idx_out, nbr_out, s)
                 : launch<2>(query, points, B, S, N, K, d_out, idx_out, nbr_out, s);
}

}  // extern "C"
