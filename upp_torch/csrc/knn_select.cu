// k-nearest-neighbour selection for large k and large clouds on Hopper
// (sm_90a).
//
// Serves the kNN calls past csrc/knn.cu's limits (k > 64 or N > 16384):
// the patch denoiser's k = min(1000, N) nearest of a few seed points over
// clouds of 10K-50K points (utils/denoise.py). In the JAX package those
// calls are XLA top_k (upp_tpu/ops/knn.py:42-52), since the Pallas kNN
// kernel upp_tpu/ops/knn_pallas.py::_knn_kernel is dispatched only for
// k <= 42 (should_dispatch, knn_pallas.py:250-261); the port's rule that a
// CUDA tensor launches a kernel or raises needs a kernel here too. Forward
// only, no gather: ops/knn.py gathers the neighbours' xyz.
//
// What it computes: for each query, the k points of its cloud with the
// smallest squared distance, ascending, ties to the lowest index: the
// stable sort of the plain PyTorch version (ops/knn.py::knn_plain), whose
// arithmetic it repeats, ((qx-px)^2 + (qy-py)^2) + (qz-pz)^2 one
// round-to-nearest op at a time, so indices are identical and distances
// bit-equal.
//
// Bound on this card: the N distance evaluations of each query and the
// passes over them; the bytes (each cloud and query read once, k outputs a
// query) and operations (about 10 a (query, point) pair) would take about a
// microsecond at the denoiser's shapes, so the passes' latency sets the
// time.
//
// Design: one block of 1024 threads per (cloud, query), few queries a call.
// The block computes the N distances once and keeps their float bits
// (non-negative, so the bits order like the values) in shared memory, or
// for N > kSmemMaxN in a row of global scratch the wrapper allocates. A
// radix select (four passes of 8-bit digits, histograms in shared memory
// with warp-aggregated atomics) finds the k-th smallest distance T and how
// many of the k lie at T; only when more points than that share T does a
// second radix select over their indices find the last one taken, so ties
// go to the lowest index. The keys (distance bits, index) of the k taken
// points are then compacted in any order and sorted by a bitonic sort of at
// most 1024 keys in shared memory: the ascending keys are the stable sort's
// result, whatever order they were found in.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kMaxK = 1024;         // the taken keys are sorted in shared memory
constexpr int kMaxN = 1048576;      // 2^20 points a cloud
constexpr int kSmemMaxN = 53248;    // distances in shared memory (208 KB) up to this N
constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Selected {
  unsigned value;  // the rank-th smallest value
  unsigned rank;   // its rank among the values equal to it, from 1
  unsigned equal;  // how many values equal it
};

// The rank-th smallest (from 1) of val(j) over the j in [0, N) with
// pred(j): four passes of 8-bit digits, the most significant first. Every
// thread of the block calls it and gets the result.
template <class Val, class Pred>
__device__ Selected radix_select(int N, unsigned rank, Val val, Pred pred, unsigned* hist,
                                 unsigned* bcast) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  unsigned prefix = 0, mask = 0, equal = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int j0 = 0; j0 < N; j0 += blockDim.x) {  // the same trip count in every lane
      const int j = j0 + tid;
      unsigned digit = 256;  // not counted
      if (j < N && pred(j)) {
        const unsigned v = val(j);
        if ((v & mask) == prefix) digit = (v >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {  // warp 0: lane l scans bins 8l .. 8l + 7
      unsigned c[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = hist[8 * lane + q];
        sum += c[q];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      unsigned below = incl - sum;
      if (below < rank && rank <= incl) {
        int digit = 0;
        unsigned count = 0;
        bool found = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (!found) {
            if (below + c[q] >= rank) {
              digit = q;
              count = c[q];
              found = true;
            } else {
              below += c[q];
            }
          }
        }
        bcast[0] = 8 * lane + digit;
        bcast[1] = below;
        bcast[2] = count;
      }
    }
    __syncthreads();
    // bcast is written again only after the next pass's two barriers
    prefix |= bcast[0] << shift;
    mask |= 255u << shift;
    rank -= bcast[1];
    equal = bcast[2];
  }
  return {prefix, rank, equal};
}

__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const float* __restrict__ query, const float* __restrict__ points, int S,
                  int N, int K, unsigned* __restrict__ scratch, float* __restrict__ d_out,
                  int* __restrict__ idx_out) {
  extern __shared__ unsigned smem_dist[];
  __shared__ unsigned hist[256];
  __shared__ unsigned bcast[3];
  __shared__ unsigned long long keys[kMaxK];
  __shared__ unsigned count;

  const int row = blockIdx.x;  // b * S + s
  const int b = row / S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* pb = points + (size_t)b * N * 3;
  unsigned* dist = scratch == nullptr ? smem_dist : scratch + (size_t)row * N;
  const float qx = query[3 * (size_t)row];
  const float qy = query[3 * (size_t)row + 1];
  const float qz = query[3 * (size_t)row + 2];
  for (int j = tid; j < N; j += blockDim.x) {
    const float dx = __fsub_rn(qx, pb[3 * j]);
    const float dy = __fsub_rn(qy, pb[3 * j + 1]);
    const float dz = __fsub_rn(qz, pb[3 * j + 2]);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    dist[j] = __float_as_uint(d);
  }
  if (tid == 0) count = 0;
  __syncthreads();

  const Selected t = radix_select(
      N, static_cast<unsigned>(K), [&](int j) { return dist[j]; }, [](int) { return true; },
      hist, bcast);
  // the k taken: every point below T and the t.rank lowest indices at T
  unsigned last = 0xffffffffu;
  if (t.equal > t.rank)
    last = radix_select(
               N, t.rank, [](int j) { return static_cast<unsigned>(j); },
               [&](int j) { return dist[j] == t.value; }, hist, bcast)
               .value;

  const unsigned lanes_below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < N; j0 += blockDim.x) {
    const int j = j0 + tid;
    const unsigned v = j < N ? dist[j] : 0xffffffffu;
    const bool take =
        j < N && (v < t.value || (v == t.value && static_cast<unsigned>(j) <= last));
    const unsigned ballot = __ballot_sync(kFull, take);
    if (ballot == 0u) continue;
    unsigned base = 0;
    if (lane == __ffs(ballot) - 1) base = atomicAdd(&count, __popc(ballot));
    base = __shfl_sync(kFull, base, __ffs(ballot) - 1);
    const unsigned at = base + __popc(ballot & lanes_below);
    if (take && at < static_cast<unsigned>(K))  // exactly K are taken
      keys[at] =
          (static_cast<unsigned long long>(v) << 32) | static_cast<unsigned>(j);
  }
  int size = 1;
  while (size < K) size <<= 1;
  for (int i = K + tid; i < size; i += blockDim.x) keys[i] = ~0ull;
  for (int width = 2; width <= size; width <<= 1) {
    for (int stride = width >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < size; i += blockDim.x) {
        const int partner = i ^ stride;
        if (partner > i) {
          const unsigned long long a = keys[i], c = keys[partner];
          if ((a > c) == ((i & width) == 0)) {
            keys[i] = c;
            keys[partner] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int m = tid; m < K; m += blockDim.x) {
    const unsigned long long key = keys[m];
    const size_t o = (size_t)row * K + m;
    d_out[o] = __uint_as_float(static_cast<unsigned>(key >> 32));
    idx_out[o] = static_cast<int>(key & 0xffffffffu);
  }
}

// The dynamic shared memory limit is raised on each device once per size,
// the first time a launch needs more than is set (beyond 48 KB a launch
// fails without it).
std::mutex g_smem_mutex;
int g_smem_limit[kMaxDevices];

cudaError_t reserve_smem(size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (g_smem_limit[dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(knn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) g_smem_limit[dev] = static_cast<int>(bytes);
  return err;
}

}  // namespace

extern "C" {

int upp_knn_select_max_k() { return kMaxK; }

int upp_knn_select_max_n() { return kMaxN; }

int upp_knn_select_smem_max_n() { return kSmemMaxN; }

const char* upp_knn_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// query [B, S, 3] f32, points [B, N, 3] f32, d_out [B, S, K] f32, idx_out
// [B, S, K] i32, all contiguous on the current device; scratch [B * S, N]
// u32 when N > kSmemMaxN, else null. Launches on `stream`; returns the CUDA
// error code.
int upp_knn_select(const float* query, const float* points, int B, int S, int N, int K,
                   unsigned* scratch, float* d_out, int* idx_out, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (N <= 0 || N > kMaxN || K <= 0 || K > kMaxK || K > N ||
      static_cast<long long>(B) * S > 0x7fffffffLL || (N > kSmemMaxN) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scratch == nullptr ? sizeof(unsigned) * static_cast<size_t>(N) : 0;
  const cudaError_t err = reserve_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_select_kernel<<<B * S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      query, points, S, N, K, scratch, d_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
