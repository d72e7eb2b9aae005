// Bidirectional Chamfer nearest neighbours on Hopper (sm_90a), one fused pass.
//
// Replaces the Pallas TPU kernel upp_tpu/ops/chamfer_pallas.py::_nn_kernel
// (its pallas_call reached through _nn_both_impl, chamfer_pallas.py:118).
//
// What it computes: for x [B, N, 3] and y [B, M, 3], per x point the squared
// distance to and index of its nearest y point (d1, i1), and per y point the
// same against x (d2, i2). Distances use the difference form
// ((qx-px)^2 + (qy-py)^2) + (qz-pz)^2 with round-to-nearest intrinsics and no
// multiply-add contraction, so the plain PyTorch version (ops/chamfer.py::
// nn_both_plain) agrees bit for bit. An invalid target gets an additive 1e30
// penalty, so it is never chosen while a valid one exists: the y-side penalty
// enters only x -> y, the x-side one only y -> x. Ties go to the lowest index.
// Values of invalid queries are computed like the others and are the
// caller's to mask (nn_distance does).
//
// What bounds it: the rate of float32 instructions. Each (x, y) pair costs 8
// rounded operations (3 sub, 3 mul, 2 add) that -fmad=false keeps apart, plus
// the updates of both directions; each point is read once and two keys
// written, so the bytes are small. At (2048, 8192) x 64 clouds that is
// 1.07e9 pairs: 0.26 ms of the card's ~33.5e12 instructions/s for the 8
// distance operations alone.
//
// Design: each pair is evaluated once and its distance reduced along both
// axes, as the Pallas kernel does. Round-to-nearest gives fl(a-b) = -fl(b-a),
// so one distance serves both directions bit for bit. The step loop has no
// branch: minima are taken by value, and indices found apart from them.
// - Roles. One cloud is resident, the other swept; the wrapper's launch plan
//   (ops/chamfer_cuda.py::launch_plan) makes the larger one resident, so the
//   card is full at every path shape, and splits the swept cloud over blocks
//   when there are few resident tiles. The row direction (resident -> swept)
//   takes the swept side's penalty, the column direction the resident side's.
// - Tiles. A block of kThreads threads owns kTileR resident points, kR a
//   thread in registers, and sweeps its split of the swept cloud through
//   shared memory in stages of kStage points (float4: x, y, z, penalty). A
//   thread evaluates kR x kC pairs a step for kC shared-memory loads
//   (broadcasts). A stage's load is not overlapped with compute: a stage is
//   thousands of instructions a thread, and the other blocks on the SM fill
//   the gap.
// - Row direction: fminf per pair into a running minimum per resident point,
//   and the step that last lowered it; at the end of the stage the index is
//   recovered from that step's staged points (the first at the minimum),
//   recomputing the very bits the minimum took.
// - Column direction: fminf over the thread's kR points, the warp's minimum
//   by one redux.sync on the float bits (d + penalty >= +0 orders like its
//   bits), the lowest index at that value by a second one; lane 0 writes the
//   packed key (bits << 32 | index) of each swept point to the warp's own row
//   in shared memory (no atomics there: a 64-bit atomicMin on shared memory
//   is a compare-and-swap loop). After the stage the block takes the minimum
//   over its warps' rows and does one 64-bit atomicMin per swept point into a
//   key buffer in global memory; the resident points' keys go there at the
//   end of the block (by atomicMin too: with a split swept cloud several
//   blocks hold part of a resident point's row).
// - Keys are unique and their minimum does not depend on order, so the
//   result has the lowest index on ties and repeats bit for bit, whatever
//   order blocks and warps run in. The wrapper's key buffer is set to all
//   ones (cudaMemsetAsync) before the fused kernel, and a second kernel
//   unpacks it into (d1, i1, d2, i2): two kernel launches a call.
// Limits: 1 <= B <= kMaxB (the grid's z dimension), 1 <= N, M <= kMaxPoints.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxB = 65535;           // the batch is the grid's z dimension
constexpr int kMaxPoints = 16777216;   // N, M: 3 * index stays far inside int
constexpr int kMaxSplits = 65535;      // the grid's y dimension
constexpr int kThreads = 128;          // threads a block
constexpr int kR = 4;                  // resident points a thread
constexpr int kC = 4;                  // swept points a step
constexpr int kTileR = 512;            // resident points a block
constexpr int kStage = 512;            // swept points a shared-memory stage (8 KB + 16 KB of keys)
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;          // additive penalty of an invalid target
constexpr float kFar = 1e30f;          // coordinate of a padding slot: its distances overflow to +inf
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
static_assert(kTileR == kThreads * kR, "a block's resident tile is kR points a thread");
static_assert(kStage % kC == 0 && kC % 2 == 0, "a stage is whole steps, stored in pairs");

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float4 p) {
  const float dx = __fsub_rn(ax, p.x);
  const float dy = __fsub_rn(ay, p.y);
  const float dz = __fsub_rn(az, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned long long pack(float d, unsigned i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | i;
}

// Grid (resident tiles, swept splits, B). kMasked: at least one validity mask
// is given (a null one means all valid); without, no penalty is added.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 4)
nn_fused_kernel(const float* __restrict__ res, const float* __restrict__ swp,
                const unsigned char* __restrict__ res_valid,
                const unsigned char* __restrict__ swp_valid, int R, int S, int split_len,
                unsigned long long* __restrict__ res_keys,
                unsigned long long* __restrict__ swp_keys) {
  __shared__ float4 tile[kStage];
  __shared__ __align__(16) unsigned long long slot[kWarps][kStage];  // a warp's column keys
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int s_begin = blockIdx.y * split_len;
  const int s_end = min(S, s_begin + split_len);
  const float* rb = res + static_cast<size_t>(b) * R * 3;
  const float* sb = swp + static_cast<size_t>(b) * S * 3;

  // resident slot i of thread t is point tile0 + i * kThreads + t; a slot past
  // R sits at kFar (distance +inf to every real point) with index kNone
  float rx[kR], ry[kR], rz[kR], rp[kR], best[kR];
  unsigned gidx[kR], best_i[kR];
  int step[kR];  // the stage's step that last lowered best, or -1
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int g = blockIdx.x * kTileR + i * kThreads + t;
    rx[i] = ry[i] = rz[i] = kFar;
    rp[i] = 0.f;
    gidx[i] = kNone;
    if (g < R) {
      rx[i] = rb[3 * g];
      ry[i] = rb[3 * g + 1];
      rz[i] = rb[3 * g + 2];
      gidx[i] = g;
      if (kMasked && res_valid != nullptr && !res_valid[static_cast<size_t>(b) * R + g]) {
        rp[i] = kBig;
      }
    }
    best[i] = CUDART_INF_F;
    best_i[i] = s_begin;  // all +inf: the first index, as argmin gives
    step[i] = -1;
  }

  for (int s0 = s_begin; s0 < s_end; s0 += kStage) {
    const int len = min(kStage, s_end - s0);
    const int padded = (len + kC - 1) / kC * kC;
    __syncthreads();  // the previous stage's points and keys are no longer read
    for (int j = t; j < padded; j += kThreads) {
      float4 p = make_float4(kFar, kFar, kFar, 0.f);
      if (j < len) {
        const int m = s0 + j;
        const bool invalid =
            kMasked && swp_valid != nullptr && !swp_valid[static_cast<size_t>(b) * S + m];
        p = make_float4(sb[3 * m], sb[3 * m + 1], sb[3 * m + 2], invalid ? kBig : 0.f);
      }
      tile[j] = p;
    }
    __syncthreads();

    for (int j0 = 0; j0 < padded; j0 += kC) {
      float4 p[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) p[c] = tile[j0 + c];
      float d[kR][kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int c = 0; c < kC; ++c) d[i][c] = sq_dist(rx[i], ry[i], rz[i], p[c]);
      }

      // row direction (resident -> swept): the value, and the step that lowered it
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float nb = best[i];
#pragma unroll
        for (int c = 0; c < kC; ++c) nb = fminf(nb, kMasked ? __fadd_rn(d[i][c], p[c].w) : d[i][c]);
        step[i] = nb < best[i] ? j0 : step[i];
        best[i] = nb;
      }

      // column direction (swept -> resident): the warp's key of each swept point
      unsigned long long key[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float v[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) v[i] = kMasked ? __fadd_rn(d[i][c], rp[i]) : d[i][c];
        float low = v[0];
#pragma unroll
        for (int i = 1; i < kR; ++i) low = fminf(low, v[i]);
        const float m = __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(low)));
        unsigned cand = kNone;
#pragma unroll
        for (int i = kR - 1; i >= 0; --i) cand = v[i] == m ? gidx[i] : cand;
        key[c] = pack(m, __reduce_min_sync(kFull, cand));
      }
      if ((t & 31) == 0) {
#pragma unroll
        for (int c = 0; c < kC; c += 2) {
          *reinterpret_cast<ulonglong2*>(&slot[warp][j0 + c]) = make_ulonglong2(key[c], key[c + 1]);
        }
      }
    }

    // the row index: the first point of the lowering step at the final value
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (step[i] >= 0) {
        unsigned k = kC - 1;
#pragma unroll
        for (int c = kC - 2; c >= 0; --c) {
          const float4 q = tile[step[i] + c];
          const float d = sq_dist(rx[i], ry[i], rz[i], q);
          k = (kMasked ? __fadd_rn(d, q.w) : d) == best[i] ? c : k;
        }
        best_i[i] = s0 + step[i] + k;
        step[i] = -1;
      }
    }

    __syncthreads();  // every warp's keys of this stage are in
    for (int j = t; j < len; j += kThreads) {
      unsigned long long k = slot[0][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) k = min(k, slot[w][j]);
      atomicMin(&swp_keys[static_cast<size_t>(b) * S + s0 + j], k);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (gidx[i] != kNone) {
      atomicMin(&res_keys[static_cast<size_t>(b) * R + gidx[i]], pack(best[i], best_i[i]));
    }
  }
}

// keys[0, n_x) -> (d1, i1), keys[n_x, total) -> (d2, i2)
__global__ void unpack_kernel(const unsigned long long* __restrict__ keys, size_t n_x,
                              size_t total, float* __restrict__ d1, int* __restrict__ i1,
                              float* __restrict__ d2, int* __restrict__ i2) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < total;
       k += stride) {
    const unsigned long long key = keys[k];
    const float d = __uint_as_float(static_cast<unsigned>(key >> 32));
    const int i = static_cast<int>(static_cast<unsigned>(key));
    if (k < n_x) {
      d1[k] = d;
      i1[k] = i;
    } else {
      d2[k - n_x] = d;
      i2[k - n_x] = i;
    }
  }
}

}  // namespace

extern "C" {

const char* upp_chamfer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [B, N, 3] f32, y [B, M, 3] f32, valid_x [B, N] / valid_y [B, M] bytes
// (non-zero = valid) or null; keys: scratch of B * (N + M) 64-bit words;
// d1 [B, N] f32, i1 [B, N] i32, d2 [B, M] f32, i2 [B, M] i32; all contiguous
// on the current device. The launch plan: swap (y resident, x swept), the
// swept cloud in `splits` splits of `split_len` points. Enqueues the key
// reset, the fused kernel and the unpack on `stream`; returns the CUDA error
// code.
int upp_chamfer_nn_both(const float* x, const float* y, const unsigned char* valid_x,
                        const unsigned char* valid_y, int B, int N, int M, int swap,
                        int splits, int split_len, unsigned long long* keys, float* d1,
                        int* i1, float* d2, int* i2, void* stream) {
  if (B <= 0) return 0;
  const int R = swap ? M : N;
  const int S = swap ? N : M;
  if (B > kMaxB || N <= 0 || M <= 0 || N > kMaxPoints || M > kMaxPoints || splits < 1 ||
      splits > kMaxSplits || split_len < 1 ||
      static_cast<long long>(splits - 1) * split_len >= S ||
      static_cast<long long>(splits) * split_len < S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_x = static_cast<size_t>(B) * N;
  const size_t total = n_x + static_cast<size_t>(B) * M;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, total * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* x_keys = keys;
  unsigned long long* y_keys = keys + n_x;
  const dim3 grid((R + kTileR - 1) / kTileR, splits, B);
  const float* res = swap ? y : x;
  const float* swp = swap ? x : y;
  const unsigned char* res_valid = swap ? valid_y : valid_x;
  const unsigned char* swp_valid = swap ? valid_x : valid_y;
  unsigned long long* res_keys = swap ? y_keys : x_keys;
  unsigned long long* swp_keys = swap ? x_keys : y_keys;
  if (valid_x != nullptr || valid_y != nullptr) {
    nn_fused_kernel<true><<<grid, kThreads, 0, s>>>(res, swp, res_valid, swp_valid, R, S,
                                                    split_len, res_keys, swp_keys);
  } else {
    nn_fused_kernel<false><<<grid, kThreads, 0, s>>>(res, swp, nullptr, nullptr, R, S,
                                                     split_len, res_keys, swp_keys);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t blocks = (total + 255) / 256;
  unpack_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      keys, n_x, total, d1, i1, d2, i2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
