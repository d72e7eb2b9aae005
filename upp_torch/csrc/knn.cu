// k-nearest-neighbour search (with optional neighbour gather) on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel upp_tpu/ops/knn_pallas.py::_knn_kernel
// (reached through _knn_gather_fwd_impl -> knn_gather / knn_idx). Forward
// only: the backward pass is plain tensor code and arrives with training.
//
// What it computes: for each query, the k points of its cloud with the
// smallest squared distance, ascending, ties to the lowest index (the
// Pallas kernel's k rounds of rowwise min with lowest-index argmin).
// Distances use the difference form (qx-px)^2 + (qy-py)^2 + (qz-pz)^2 like
// the Pallas kernel, with round-to-nearest intrinsics and no multiply-add
// contraction: the plain PyTorch version does the same arithmetic, so both
// agree bit for bit. With `nbr` non-null it also writes the neighbours' xyz.
//
// Bound on this card: the S*N distance evaluations (9 flops each) and the
// insertions into the sorted lists, issued by only S threads per cloud; the
// bytes (each point and query read once, k outputs per query) are small.
//
// Design: a block per (cloud, tile of queries) stages the cloud's points in
// shared memory (structure of arrays, 12 bytes a point); each thread owns one
// query and keeps its sorted top-k in registers (the list is fully unrolled
// over kMaxK, so it never spills to local memory). Points are scanned in
// index order and inserted on a strict `<` against the current k-th
// distance, which yields the lowest-index ties.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kMaxN = 16384;  // 12 bytes a point: 192 KB of shared memory
constexpr int kMaxThreads = 128;

__global__ void knn_kernel(const float* __restrict__ query,
                           const float* __restrict__ points, int S, int N, int K,
                           float* __restrict__ d_out, int* __restrict__ idx_out,
                           float* __restrict__ nbr_out) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + N;
  float* pz = py + N;
  const int b = blockIdx.y;
  const float* pb = points + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    px[j] = pb[3 * j];
    py[j] = pb[3 * j + 1];
    pz[j] = pb[3 * j + 2];
  }
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t row = (size_t)b * S + s;
  const float qx = query[3 * row], qy = query[3 * row + 1], qz = query[3 * row + 2];

  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int m = 0; m < kMaxK; ++m) {
    bd[m] = CUDART_INF_F;
    bi[m] = 0;
  }
  float worst = CUDART_INF_F;  // bd[K-1]
  for (int j = 0; j < N; ++j) {
    const float dx = __fsub_rn(qx, px[j]);
    const float dy = __fsub_rn(qy, py[j]);
    const float dz = __fsub_rn(qz, pz[j]);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < worst) {
      // insert after every entry <= d: walk down, shifting larger entries
#pragma unroll
      for (int m = kMaxK - 1; m >= 0; --m) {
        if (m < K) {
          if (m > 0 && bd[m - 1] > d) {
            bd[m] = bd[m - 1];
            bi[m] = bi[m - 1];
          } else if (bd[m] > d) {
            bd[m] = d;
            bi[m] = j;
          }
          if (m == K - 1) worst = bd[m];
        }
      }
    }
  }

  float* dr = d_out + row * K;
  int* ir = idx_out + row * K;
#pragma unroll
  for (int m = 0; m < kMaxK; ++m) {
    if (m < K) {
      dr[m] = bd[m];
      ir[m] = bi[m];
      if (nbr_out != nullptr) {
        float* nr = nbr_out + (row * K + m) * 3;
        nr[0] = px[bi[m]];
        nr[1] = py[bi[m]];
        nr[2] = pz[bi[m]];
      }
    }
  }
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
  if (N <= 0 || N > kMaxN || K <= 0 || K > kMaxK || K > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(kMaxThreads, (S + 31) / 32 * 32);
  const dim3 grid((S + threads - 1) / threads, B);
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(N);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      query, points, S, N, K, d_out, idx_out, nbr_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
