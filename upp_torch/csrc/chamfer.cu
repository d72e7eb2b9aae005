// Bidirectional Chamfer nearest neighbours on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel upp_tpu/ops/chamfer_pallas.py::_nn_kernel
// (reached through _nn_both_impl -> nn_both -> chamfer.nn_distance).
//
// What it computes: for x [B, N, 3] and y [B, M, 3], per x point the squared
// distance to and index of its nearest y point (d1, i1), and per y point the
// same against x (d2, i2). Distances use the difference form
// ((qx-px)^2 + (qy-py)^2) + (qz-pz)^2 with round-to-nearest intrinsics and no
// multiply-add contraction, so the plain PyTorch version (ops/chamfer.py::
// nn_both_plain) agrees bit for bit. An invalid target gets an additive 1e30
// penalty, so it is never chosen while a valid one exists. Ties go to the
// lowest index: targets are scanned in index order and the best is replaced
// only on a strict `<`. Values of invalid queries are computed like the
// others and are the caller's to mask (nn_distance does).
//
// Bound on this card: the N*M distance evaluations per direction (about 10
// float32 operations each); the bytes (each point read once, one float and
// one int written per point) are small. At the pretask shapes (up to
// 2048 x 8192 per cloud) the work is 1e9 pairs a step.
//
// Design (simple first): one launch per direction of one direction kernel.
// A block holds 256 queries, one per thread, with a running min/argmin in
// registers; the target cloud streams through shared memory in tiles of
// kTile points packed as float4 (x, y, z, penalty), so any M works and every
// thread reads the same tile entry at once (a shared-memory broadcast).
// The Pallas kernel's fusion of both directions over one distance tile is a
// later speed-up.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 1024;      // target points per shared-memory tile (16 KB)
constexpr int kThreads = 256;    // queries per block
constexpr float kBig = 1e30f;    // additive penalty of an invalid target

__global__ void nn_kernel(const float* __restrict__ q, const float* __restrict__ p,
                          const unsigned char* __restrict__ valid_p, int N, int M,
                          float* __restrict__ d_out, int* __restrict__ i_out) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = n < N;
  const float* pb = p + (size_t)b * M * 3;
  const unsigned char* vb = valid_p ? valid_p + (size_t)b * M : nullptr;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const size_t row = (size_t)b * N + n;
    qx = q[3 * row];
    qy = q[3 * row + 1];
    qz = q[3 * row + 2];
  }
  float best = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < M; base += kTile) {
    const int len = min(kTile, M - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int m = base + j;
      const float pen = (vb == nullptr || vb[m]) ? 0.f : kBig;
      tile[j] = make_float4(pb[3 * m], pb[3 * m + 1], pb[3 * m + 2], pen);
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < len; ++j) {
        const float4 t = tile[j];
        const float dx = __fsub_rn(qx, t.x);
        const float dy = __fsub_rn(qy, t.y);
        const float dz = __fsub_rn(qz, t.z);
        const float d = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)),
            t.w);
        if (d < best) {
          best = d;
          best_i = base + j;
        }
      }
    }
  }
  if (active) {
    const size_t row = (size_t)b * N + n;
    d_out[row] = best;
    i_out[row] = best_i;
  }
}

cudaError_t launch_direction(const float* q, const float* p, const unsigned char* valid_p,
                             int B, int N, int M, float* d_out, int* i_out,
                             cudaStream_t stream) {
  const int threads = min(kThreads, (N + 31) / 32 * 32);
  const dim3 grid((N + threads - 1) / threads, B);
  nn_kernel<<<grid, threads, 0, stream>>>(q, p, valid_p, N, M, d_out, i_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* upp_chamfer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [B, N, 3] f32, y [B, M, 3] f32, valid_x [B, N] / valid_y [B, M] bytes
// (non-zero = valid) or null; d1 [B, N] f32, i1 [B, N] i32, d2 [B, M] f32,
// i2 [B, M] i32; all contiguous on the current device. Launches both
// directions on `stream`; returns the CUDA error code.
int upp_chamfer_nn_both(const float* x, const float* y, const unsigned char* valid_x,
                        const unsigned char* valid_y, int B, int N, int M, float* d1,
                        int* i1, float* d2, int* i2, void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || M <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_direction(x, y, valid_y, B, N, M, d1, i1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_direction(y, x, valid_x, B, M, N, d2, i2, s));
}

}  // extern "C"
