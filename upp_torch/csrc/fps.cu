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
// start. Without a 2e10 slot the start is the first valid slot.
//
// Bound on this card: latency. The S rounds depend on each other, and each
// round moves only 16 bytes per point through shared memory; what bytes and
// operations the function needs (one read of xyz, ~9 flops per point and
// round) would take microseconds, while each round costs a block-wide
// argmax with two barriers.
//
// Design: one thread block per cloud, so the coordinates (structure of
// arrays) and the running distance table stay in shared memory for all S
// rounds and nothing goes back to device memory between rounds. Each thread
// updates its strided share of the points and keeps its best (value, index);
// a warp-shuffle argmax and a shared-memory pass over the warps pick the
// winner, which the next round reads from shared memory. The squared
// distance is (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics and no
// multiply-add contraction, the arithmetic of the plain PyTorch version, so
// both pick identical indices over all S dependent rounds.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 14336;  // 4 floats a point: 224 KB of shared memory

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const float* __restrict__ init, int N, int S,
                           int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  float* sd = sz + N;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_j[32];
  __shared__ int cur_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  const float* in = init + (size_t)b * N;

  // stage the cloud; find the explicit start and the first valid slot
  int first_explicit = N, first_valid = N;
  for (int j = tid; j < N; j += T) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
    const float v = in[j];
    sd[j] = v;
    if (v > 1.5e10f && j < first_explicit) first_explicit = j;
    if (v > 0.f && j < first_valid) first_valid = j;
  }
  for (int off = 16; off > 0; off >>= 1) {
    first_explicit = min(first_explicit, __shfl_down_sync(0xffffffffu, first_explicit, off));
    first_valid = min(first_valid, __shfl_down_sync(0xffffffffu, first_valid, off));
  }
  if (lane == 0) {
    red_i[warp] = first_explicit;
    red_j[warp] = first_valid;
  }
  __syncthreads();
  if (warp == 0) {
    int e = lane < nwarps ? red_i[lane] : N;
    int f = lane < nwarps ? red_j[lane] : N;
    for (int off = 16; off > 0; off >>= 1) {
      e = min(e, __shfl_down_sync(0xffffffffu, e, off));
      f = min(f, __shfl_down_sync(0xffffffffu, f, off));
    }
    if (lane == 0) cur_s = e < N ? e : (f < N ? f : 0);
  }
  __syncthreads();

  for (int i = 0; i < S; ++i) {
    const int cur = cur_s;
    if (tid == 0) idx_out[(size_t)b * S + i] = cur;
    const float cx = sx[cur], cy = sy[cur], cz = sz[cur];
    float bv = -CUDART_INF_F;
    int bi = N;
    for (int j = tid; j < N; j += T) {
      const float dx = __fsub_rn(sx[j], cx);
      const float dy = __fsub_rn(sy[j], cy);
      const float dz = __fsub_rn(sz[j], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float nd = fminf(sd[j], d);
      sd[j] = nd;
      if (nd > bv) {  // strict: a thread visits its points in index order
        bv = nd;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                  __shfl_down_sync(0xffffffffu, bi, off));
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : N;
      for (int off = 16; off > 0; off >>= 1) {
        take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                    __shfl_down_sync(0xffffffffu, bi, off));
      }
      if (lane == 0) cur_s = bi;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int upp_fps_max_n() { return kMaxN; }

const char* upp_fps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xyz [B, N, 3] f32, init [B, N] f32, idx_out [B, S] i32, all contiguous on
// the current device. Launches on `stream`; returns the CUDA error code.
int upp_fps(const float* xyz, const float* init, int B, int N, int S,
            int* idx_out, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(1024, (N + 31) / 32 * 32);
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(N);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(xyz, init, N, S,
                                                                       idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
