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
// Bound on this card: the bytes (each cloud and query read once, k outputs
// a query) and operations (about 10 a (query, point) pair) take about a
// microsecond at the denoiser's shapes; what sets the time is reading the
// cloud once a query from L2 and the latency of the passes that depend on
// each other.
//
// Design. Every point has a key: the distance's float bits (non-negative,
// so they order like the value; bit 31 is 0) above its index (20 bits, N
// <= 2^20): key = bits << 20 | j, 51 bits, unique within a query, and
// ordered exactly as the stable sort orders (distance, index). The k taken
// points are the k smallest keys.
//
// 1. A query is split over a thread-block cluster of C blocks (C and the
//    threads a block from the number of queries and N, plan_of: enough
//    blocks to fill the 132 SMs about once). Block r owns the contiguous
//    share [r * share, (r + 1) * share) of the cloud (at most
//    kMaxStoredShare points), read 4 points a lane as three 16-byte loads
//    (a warp reads 1536 contiguous bytes; scalar loads where the cloud is
//    not 16-byte aligned).
// 2. Pass 1 computes each distance once and counts the key's first digit,
//    its bits 50..40 (distance bits 30..20: 8 bins an octave), in the
//    block's histogram by a shared atomicAdd a point, and keeps the digit in
//    shared memory (2 bytes a point). Each block adds its non-zero bins
//    into rank 0's histogram through distributed shared memory; after a
//    cluster barrier rank 0 finds the boundary bin (the one holding the
//    k-th key), the count below it and in it, and after a second barrier
//    every block reads that.
// 3. When the bin holds more keys than kCandidates (tie-heavy clouds:
//    thousands of points at one distance), the kernel refines the boundary
//    on the shares: one more pass a digit, 8 bits of the key at a time (the
//    distance's low bits, then the index's: the index select on ties),
//    counting only keys that carry the prefix so far, merged and scanned the
//    same way, until the prefix holds at most kCandidates keys (a full
//    51-bit prefix holds one). A last pass then marks each point of the
//    boundary's first digit by its key: digit 0 if at or below the prefix,
//    none if above.
// 4. Pass 2: now a kept digit at most the prefix's first digit means a key
//    at or below the prefix: the k - r keys below it and every key with it
//    (k - 1 + kCandidates at most in the cluster). The block lists those
//    points from its digits alone, then loads just them and recomputes
//    their keys (the same bits: same arithmetic, same operands) into the
//    memory the digits held. No global scratch.
// 5. Each block sorts its keys: runs of 32 in registers by a bitonic
//    network of __shfl_xor_sync, no barrier, then runs merged pairwise, each
//    key placed by a binary search of the other run, one barrier a merge
//    level. After a cluster barrier each block copies its peers' sorted runs
//    through distributed shared memory, and places each of its keys among
//    all of the cluster's: its index in its own run plus, for every peer,
//    the count of the peer's keys below it. The keys placed below k are the
//    answer; each block writes its own, so no block waits on one block's
//    sort of all k. The boundary's keys need no select of their own: their
//    places order them with the rest.
//
// Why it is exact. (a) The taken set: the merged histogram counts every
// key of the query once (each point is in exactly one share), so the
// boundary bin and the counts below and in it are those of the whole cloud.
// The gathered keys are every key whose top bits are at most the boundary
// prefix, whatever block holds them: the k - r keys below the prefix and
// all keys with it, of which the r smallest complete the k. Every key not
// gathered is above the prefix, so larger than every gathered key; hence
// the k smallest gathered keys are the k smallest keys of the query, and
// the place of a gathered key among the gathered keys is its place among
// all. Keys are unique, so the places are a permutation and the first k in
// ascending order are the stable sort's first k, however the work was
// split. (b) The overflow path: each refining pass counts, over every
// share, exactly the keys that carry the prefix, so it is the next digit of
// the same radix select; it ends by the 51st bit at the latest, where the
// prefix is one key. The marking pass compares each key of the boundary's
// first digit with the final prefix, so pass 2 gathers exactly the keys at
// or below it, k - 1 + kCandidates at most. Recomputed distances are the
// pass-1 bits. (c) Lifetimes: a block's shared memory is accessed by
// another block only at rank 0's histograms and boundary (the adds, the
// reads) and at each block's sorted run (the peers' copies). The first
// cluster barrier comes after every block zeroed its counters; the adds of
// a pass come before the barrier that ends it; a block reads rank 0's
// boundary before it arrives at the next barrier; the runs are read only
// after the barrier that follows every block's sort, and each block
// arrives at the last, split, cluster barrier after its copies and waits on
// it before it leaves. So no block leaves while a peer may still write into
// or read from its shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 1024;             // k, at most
constexpr int kMaxN = 1048576;          // 2^20 points a cloud: an index fits the key's low 20 bits
constexpr int kCandidates = 1024;       // keys with the boundary prefix, at most, before pass 2
constexpr int kGathered = 2048;         // kMaxK + kCandidates: a block's keys in pass 2, at most
constexpr int kMaxCluster = 16;         // blocks a query (past 8 a non-portable cluster size)
constexpr int kMaxStoredShare = 65536;  // points a block: its first digits fill 128 KB
constexpr int kSMs = 132;               // the H100's
constexpr int kTargetBlocks = 660;      // 5 blocks of 256 threads on each SM
constexpr int kMinShare = 512;          // no more blocks a query than leave each this many points
constexpr int kIndexBits = 20;
constexpr int kTopShift = 40;           // the first digit: key bits 50..40
constexpr int kTopBins = 2048;
constexpr unsigned kNoDigit = 0xffffu;  // not counted, not gathered
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGathered == kMaxK + kCandidates, "pass 2 gathers k - 1 + kCandidates keys at most");
static_assert(kMaxCluster * kMaxStoredShare >= kMaxN, "every share keeps its first digits");

using Key = unsigned long long;
constexpr int kKeyBytes = 2 * kGathered * static_cast<int>(sizeof(Key));  // keys and spare

struct Select {
  Key prefix;      // the k-th key's bits at and above `shift`
  unsigned shift;  // 40, 32, ..., 0
  unsigned rank;   // its rank among the keys with that prefix, from 1
  unsigned count;  // how many keys have that prefix
};

__device__ __forceinline__ unsigned dist_bits(float qx, float qy, float qz, float px, float py,
                                              float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __float_as_uint(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

__device__ __forceinline__ Key make_key(unsigned bits, int j) {
  return (static_cast<Key>(bits) << kIndexBits) | static_cast<unsigned>(j);
}

// Points j .. j + 3 of the cloud `pb` (those below `end`): three 16-byte
// loads when `vec` (the cloud 16-byte aligned, j a multiple of 4) and all
// four are in the share, else scalar loads.
__device__ __forceinline__ void load_quad(const float* __restrict__ pb, int j, int end, bool vec,
                                          float (&x)[4], float (&y)[4], float (&z)[4]) {
  if (vec && j + 4 <= end) {
    const float4* p = reinterpret_cast<const float4*>(pb + 3 * static_cast<size_t>(j));
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    x[0] = a.x; y[0] = a.y; z[0] = a.z;
    x[1] = a.w; y[1] = b.x; z[1] = b.y;
    x[2] = b.z; y[2] = b.w; z[2] = c.x;
    x[3] = c.y; y[3] = c.z; z[3] = c.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = j + e < end ? j + e : j;
    x[e] = __ldg(pb + 3 * static_cast<size_t>(i));
    y[e] = __ldg(pb + 3 * static_cast<size_t>(i) + 1);
    z[e] = __ldg(pb + 3 * static_cast<size_t>(i) + 2);
  }
}

__device__ __forceinline__ void unpack(uint2 q, unsigned (&dg)[4]) {
  dg[0] = q.x & 0xffffu;
  dg[1] = q.x >> 16;
  dg[2] = q.y & 0xffffu;
  dg[3] = q.y >> 16;
}

// Counts `digit` (kNoDigit: nothing) in `hist`: a shared atomicAdd a point,
// which timed faster than one a warp's run of equal digits found by
// __match_any_sync (scripts/torch_kernel_variants.py). Every lane of the
// warp calls it.
__device__ __forceinline__ void count(unsigned* hist, unsigned digit) {
  if (digit != kNoDigit) atomicAdd(&hist[digit], 1u);
}

// Adds the block's non-zero bins of hist[0, nbins) into rank 0's and zeroes them.
__device__ __forceinline__ void push_bins(cg::cluster_group& cluster, unsigned* hist, int nbins) {
  unsigned* dst = cluster.map_shared_rank(hist, 0);
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const unsigned c = hist[i];
    if (c != 0u) {
      atomicAdd(dst + i, c);
      hist[i] = 0u;
    }
  }
}

// The split cluster barrier: arrive (this thread's accesses to peers' shared
// memory are done), then, later, wait for every thread of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The bin of hist[0, nbins) that holds the rank-th (from 1) counted key:
// (bin, count in the bins below it, count in it). Every thread of the block
// calls it and gets the result.
template <int kThreads>
__device__ uint3 find_rank(const unsigned* hist, int nbins, unsigned rank, unsigned* warp_sums,
                           uint3* found) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = nbins >= kThreads ? nbins / kThreads : 1;
  const int first = tid * per;
  unsigned sum = 0;
  if (first < nbins)
    for (int q = 0; q < per; ++q) sum += hist[first + q];
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    unsigned wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < kThreads / 32) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  unsigned below = warp_sums[warp] + incl - sum;
  if (first < nbins && below < rank && rank <= below + sum) {
    for (int q = 0; q < per; ++q) {
      const unsigned c = hist[first + q];
      if (rank <= below + c) {
        *found = make_uint3(static_cast<unsigned>(first + q), below, c);
        break;
      }
      below += c;
    }
  }
  __syncthreads();
  return *found;
}

// How many of the ascending a[0, len) are below `key`: a binary search by
// halving steps, without a data-dependent branch.
__device__ __forceinline__ int count_below(const Key* a, int len, Key key) {
  int lo = 0;
  for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0; step >>= 1)
    if (lo + step <= len && a[lo + step - 1] < key) lo += step;
  return lo;
}

// Sorts one key a lane ascending across the warp: a bitonic network of
// __shfl_xor_sync, 15 steps, no barrier.
__device__ __forceinline__ Key warp_sort32(Key v, int lane) {
#pragma unroll
  for (int width = 2; width <= 32; width <<= 1) {
#pragma unroll
    for (int stride = width >> 1; stride > 0; stride >>= 1) {
      const Key o = __shfl_xor_sync(kFull, v, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & width) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  return v;
}

// Sorts the unique keys a[0, n) ascending (n <= kGathered; b as large):
// runs of 32 in registers (warp_sort32, the last run padded with the
// largest key past n), then runs merged pairwise, each key placed by
// count_below in the other run; one barrier a merge level. Returns the
// buffer that holds the result.
template <int kThreads>
__device__ Key* block_sort(Key* a, Key* b, int n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i0 = tid & ~31; i0 < n; i0 += kThreads) {  // the same trip count in every lane
    const int i = i0 + lane;
    a[i] = warp_sort32(i < n ? a[i] : ~0ull, lane);
  }
  for (int run = 32; run < n; run <<= 1) {
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int s = i & ~(2 * run - 1);
      const Key key = a[i];
      if ((i & run) == 0)
        b[i + count_below(a + s + run, max(0, min(run, n - s - run)), key)] = key;
      else
        b[i - run + count_below(a + s, run, key)] = key;
    }
    Key* t = a;
    a = b;
    b = t;
  }
  __syncthreads();
  return a;
}

// The cluster blockIdx.x / C serves query row = b * S + s; its block r the
// points [r * share, (r + 1) * share) of cloud b. `stats` (2 u32 a row, or
// null): the boundary bin's count after pass 1 and the number of refining
// passes.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == 256 ? 5 : 1)
knn_select_kernel(const float* __restrict__ query, const float* __restrict__ points, int S,
                  int N, int K, int share, float* __restrict__ d_out,
                  int* __restrict__ idx_out, unsigned* __restrict__ stats) {
  // 4 first digits of 16 bits a uint2 until pass 2 has listed its points;
  // then the block's keys and the sort's spare, kGathered each
  extern __shared__ uint2 dyn[];
  uint2* digit_quads = dyn;
  Key* keys = reinterpret_cast<Key*>(dyn);
  Key* spare = keys + kGathered;
  __shared__ union {
    unsigned hist[kTopBins];   // pass 1's first digits (rank 0's: the cluster's)
    unsigned list[kGathered];  // then pass 2's points; then each key's place
  } u;
  __shared__ unsigned hist8[256];  // a refining digit's bins
  __shared__ unsigned warp_sums[32];
  __shared__ uint3 found;
  __shared__ Select sel;           // rank 0's: the cluster's boundary
  __shared__ unsigned n_list;
  __shared__ int run_len, run_in_spare;  // the block's sorted keys, read by its peers
  __shared__ int peer_len[kMaxCluster], peer_off[kMaxCluster + 1];
  __shared__ const Key* peer_run[kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.x / C;
  const int b = row / S;
  const int tid = threadIdx.x;
  const float* pb = points + static_cast<size_t>(b) * N * 3;
  const float qx = query[3 * static_cast<size_t>(row)];
  const float qy = query[3 * static_cast<size_t>(row) + 1];
  const float qz = query[3 * static_cast<size_t>(row) + 2];
  const int begin = min(N, rank * share);
  const int end = min(N, begin + share);
  const int groups = (end - begin + 3) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(pb) & 15u) == 0u;

  for (int i = tid; i < kTopBins; i += kThreads) u.hist[i] = 0u;
  for (int i = tid; i < 256; i += kThreads) hist8[i] = 0u;
  cluster.sync();  // every block zeroed and running before any remote access

  // pass 1: distances, first digits, the block's histogram
  for (int g0 = 0; g0 < groups; g0 += kThreads) {  // the same trip count in every lane
    const int g = g0 + tid;
    const int j = begin + 4 * g;
    unsigned dg[4] = {kNoDigit, kNoDigit, kNoDigit, kNoDigit};
    if (g < groups) {
      float x[4], y[4], z[4];
      load_quad(pb, j, end, vec, x, y, z);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < end)
          dg[e] = dist_bits(qx, qy, qz, x[e], y[e], z[e]) >> (kTopShift - kIndexBits);
      digit_quads[g] = make_uint2(dg[0] | dg[1] << 16, dg[2] | dg[3] << 16);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) count(u.hist, dg[e]);
  }
  __syncthreads();
  if (rank != 0) push_bins(cluster, u.hist, kTopBins);
  cluster.sync();  // the cluster's first-digit histogram is in rank 0's
  if (rank == 0) {
    const uint3 f = find_rank<kThreads>(u.hist, kTopBins, static_cast<unsigned>(K), warp_sums,
                                        &found);
    if (tid == 0) sel = Select{f.x, kTopShift, static_cast<unsigned>(K) - f.y, f.z};
  }
  cluster.sync();  // rank 0's first boundary is set
  Select s = *cluster.map_shared_rank(&sel, 0);
  const unsigned first_count = s.count;
  unsigned refines = 0;

  // the overflow path: refine the prefix by 8 bits a pass over the shares
  while (s.count > static_cast<unsigned>(kCandidates)) {
    const unsigned top = static_cast<unsigned>(s.prefix >> (kTopShift - s.shift));
    for (int g0 = 0; g0 < groups; g0 += kThreads) {
      const int g = g0 + tid;
      const int j = begin + 4 * g;
      unsigned d8[4] = {kNoDigit, kNoDigit, kNoDigit, kNoDigit};
      if (g < groups) {
        unsigned dg[4];
        unpack(digit_quads[g], dg);
        if (dg[0] == top || dg[1] == top || dg[2] == top || dg[3] == top) {
          float x[4], y[4], z[4];
          load_quad(pb, j, end, vec, x, y, z);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (dg[e] == top) {
              const Key k = make_key(dist_bits(qx, qy, qz, x[e], y[e], z[e]), j + e);
              if ((k >> s.shift) == s.prefix)
                d8[e] = static_cast<unsigned>(k >> (s.shift - 8)) & 255u;
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) count(hist8, d8[e]);
    }
    __syncthreads();
    if (rank != 0) push_bins(cluster, hist8, 256);
    cluster.sync();  // the digit's cluster histogram is in rank 0's
    if (rank == 0) {
      const uint3 f = find_rank<kThreads>(hist8, 256, s.rank, warp_sums, &found);
      for (int i = tid; i < 256; i += kThreads) hist8[i] = 0u;
      if (tid == 0) sel = Select{(s.prefix << 8) | f.x, s.shift - 8, s.rank - f.y, f.z};
    }
    cluster.sync();  // rank 0's refined boundary is set
    s = *cluster.map_shared_rank(&sel, 0);
    ++refines;
  }
  const unsigned top = static_cast<unsigned>(s.prefix >> (kTopShift - s.shift));
  if (refines != 0) {
    // the points whose first digit is the prefix's are marked by their key:
    // 0 if it is at or below the prefix, kNoDigit if above
    for (int g = tid; g < groups; g += kThreads) {
      unsigned dg[4];
      unpack(digit_quads[g], dg);
      if (dg[0] == top || dg[1] == top || dg[2] == top || dg[3] == top) {
        const int j = begin + 4 * g;
        float x[4], y[4], z[4];
        load_quad(pb, j, end, vec, x, y, z);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (dg[e] == top)
            dg[e] = (make_key(dist_bits(qx, qy, qz, x[e], y[e], z[e]), j + e) >> s.shift) <=
                    s.prefix ? 0u : kNoDigit;
        digit_quads[g] = make_uint2(dg[0] | dg[1] << 16, dg[2] | dg[3] << 16);
      }
    }
  }

  // pass 2: a first digit at most `top` now means a key at or below the
  // prefix. List those points from the digits alone, without atomics: each
  // warp counts its points, a scan gives each warp its offset, and the warp
  // writes them from there in a second read of its digits. Then load them.
  {
    const int warp = tid >> 5;
    const unsigned lanes_below = (1u << (tid & 31)) - 1u;
    unsigned listed = 0;  // the warp's points (every lane keeps the sum)
    for (int round = 0; round < 2; ++round) {
      for (int g0 = 0; g0 < groups; g0 += kThreads) {  // the same trip count in every lane
        const int g = g0 + tid;
        const uint2 q = g < groups ? digit_quads[g] : make_uint2(kFull, kFull);
        const unsigned lowest = __vminu2(q.x, q.y);  // the smaller digit of each half
        if (!__any_sync(kFull, min(lowest & 0xffffu, lowest >> 16) <= top)) continue;
        unsigned dg[4];
        unpack(q, dg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned ballot = __ballot_sync(kFull, dg[e] <= top);
          if (round == 1 && dg[e] <= top)
            u.list[listed + __popc(ballot & lanes_below)] =
                static_cast<unsigned>(begin + 4 * g + e);
          listed += __popc(ballot);
        }
      }
      if (round == 0) {
        if ((tid & 31) == 0) warp_sums[warp] = listed;
        __syncthreads();
        if (warp == 0) {
          const unsigned w = tid < kThreads / 32 ? warp_sums[tid] : 0u;
          unsigned incl = w;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const unsigned v = __shfl_up_sync(kFull, incl, o);
            if (tid >= o) incl += v;
          }
          if (tid < kThreads / 32) warp_sums[tid] = incl - w;
          if (tid == 31) n_list = incl;
        }
        __syncthreads();
        listed = warp_sums[warp];
      }
    }
  }
  __syncthreads();  // the digits are read: their memory holds keys from here
  const int n = static_cast<int>(n_list);
  for (int i = tid; i < n; i += kThreads) {
    const int j = static_cast<int>(u.list[i]);
    const float* p = pb + 3 * static_cast<size_t>(j);
    keys[i] = make_key(dist_bits(qx, qy, qz, __ldg(p), __ldg(p + 1), __ldg(p + 2)), j);
  }
  __syncthreads();
  const Key* run = block_sort<kThreads>(keys, spare, n);
  if (tid == 0) {
    run_len = n;
    run_in_spare = run == spare;
  }
  cluster.sync();  // every block's keys are sorted

  // each block places its own keys among all the cluster's: a key's place is
  // its index in its block's run plus the count below it in every peer's run
  Key* peers = run == spare ? keys : spare;
  if (tid < C) {
    int len = 0;
    const Key* src = nullptr;
    if (tid != rank) {
      len = *cluster.map_shared_rank(&run_len, tid);
      src = *cluster.map_shared_rank(&run_in_spare, tid) ? cluster.map_shared_rank(spare, tid)
                                                         : cluster.map_shared_rank(keys, tid);
    }
    peer_len[tid] = len;
    peer_run[tid] = src;
  }
  __syncthreads();
  if (tid == 0) {
    int off = 0;
    for (int r = 0; r < C; ++r) {
      peer_off[r] = off;
      off += peer_len[r];
    }
    peer_off[C] = off;
  }
  __syncthreads();
  for (int i0 = tid; i0 < peer_off[C]; i0 += 4 * kThreads) {  // the peers' runs, end to end
    Key v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // four loads in flight
      const int i = i0 + e * kThreads;
      if (i < peer_off[C]) {
        int r = 0;
        while (peer_off[r + 1] <= i) ++r;
        v[e] = peer_run[r][i - peer_off[r]];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i0 + e * kThreads < peer_off[C]) peers[i0 + e * kThreads] = v[e];
  }
  cluster_arrive();  // this block reads no peer's shared memory any more
  const int placed = min(n, K);  // a key at index >= K has >= K keys below it
  for (int i = tid; i < placed; i += kThreads) u.list[i] = static_cast<unsigned>(i);
  __syncthreads();
  for (int p = tid; p < placed * C; p += kThreads) {  // (key, peer) pairs
    const int i = p / C;
    const int r = p - i * C;
    if (r != rank) {
      const int below = count_below(peers + peer_off[r], peer_len[r], run[i]);
      if (below != 0) atomicAdd(&u.list[i], static_cast<unsigned>(below));
    }
  }
  __syncthreads();
  float* d_row = d_out + static_cast<size_t>(row) * K;
  int* idx_row = idx_out + static_cast<size_t>(row) * K;
  for (int i = tid; i < placed; i += kThreads) {
    const int at = static_cast<int>(u.list[i]);
    if (at < K) {
      d_row[at] = __uint_as_float(static_cast<unsigned>(run[i] >> kIndexBits));
      idx_row[at] = static_cast<int>(run[i] & ((1u << kIndexBits) - 1u));
    }
  }
  if (stats != nullptr && rank == 0 && tid == 0) {
    stats[2 * row] = first_count;
    stats[2 * row + 1] = refines;
  }
  cluster_wait();  // no peer reads this block's shared memory any more
}

using SelectKernel = void (*)(const float*, const float*, int, int, int, int, float*, int*,
                              unsigned*);

struct Plan {
  int clusters;  // C, blocks a query
  int threads;   // a block's
  int share;     // points a block, a multiple of 4
};

// Few queries (two blocks each fit the SMs): blocks of 1024 threads, one an
// SM, C doubled while the blocks still fit the SMs once; else blocks of 256
// threads, five an SM (their registers and shared memory allow it), C
// doubled while they fit kTargetBlocks. Never a share below kMinShare
// points, unless a share's first digits would not fit shared memory.
Plan plan_of(long long rows, int N) {
  const bool few = rows * 2 <= kSMs;
  const long long room = few ? kSMs : kTargetBlocks;
  int c = 1;
  while (c < kMaxCluster && rows * 2 * c <= room && N / (2 * c) >= kMinShare) c *= 2;
  while (c < kMaxCluster && (N + c - 1) / c > kMaxStoredShare) c *= 2;
  const int share = ((N + c - 1) / c + 3) / 4 * 4;
  return {c, few ? 1024 : 256, share};
}

SelectKernel kernel_of(int threads) {
  return threads == 256 ? knn_select_kernel<256> : knn_select_kernel<1024>;
}

size_t dynamic_bytes(int share) {
  const size_t digits = 2 * static_cast<size_t>(share);
  return digits > static_cast<size_t>(kKeyBytes) ? digits : static_cast<size_t>(kKeyBytes);
}

// Each instance's cluster and shared memory attributes are set on each
// device once (beyond 48 KB of shared memory a launch fails without them;
// 16 blocks a cluster needs the non-portable size allowed).
std::mutex g_attr_mutex;
bool g_attr_set[2][kMaxDevices];

cudaError_t reserve(int threads) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int slot = threads == 256 ? 0 : 1;
  std::lock_guard<std::mutex> lock(g_attr_mutex);
  if (g_attr_set[slot][dev]) return cudaSuccess;
  const SelectKernel kernel = kernel_of(threads);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dynamic_bytes(kMaxStoredShare)));
  if (err == cudaSuccess) g_attr_set[slot][dev] = true;
  return err;
}

int launch(const float* query, const float* points, int B, int S, int N, int K, float* d_out,
           int* idx_out, unsigned* stats, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  const long long rows = static_cast<long long>(B) * S;
  if (N <= 0 || N > kMaxN || K <= 0 || K > kMaxK || K > N || rows * kMaxCluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_of(rows, N);
  if (plan.share > kMaxStoredShare) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = reserve(plan.threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * plan.clusters));
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = dynamic_bytes(plan.share);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel_of(plan.threads), query, points, S, N, K, plan.share,
                           d_out, idx_out, stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int upp_knn_select_max_k() { return kMaxK; }

int upp_knn_select_max_n() { return kMaxN; }

const char* upp_knn_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan for `rows` = B * S queries over clouds of N points:
// out[0] blocks a query (C), out[1] threads a block.
void upp_knn_select_plan(int rows, int N, int* out) {
  const Plan plan = plan_of(rows, N);
  out[0] = plan.clusters;
  out[1] = plan.threads;
}

// query [B, S, 3] f32, points [B, N, 3] f32, d_out [B, S, K] f32, idx_out
// [B, S, K] i32, all contiguous on the current device; `stats` null, or [B
// * S, 2] u32 on the device for each query's count of keys in the boundary
// bin after pass 1 and its number of refining passes. Launches on
// `stream`; returns the CUDA error code.
int upp_knn_select(const float* query, const float* points, int B, int S, int N, int K,
                   float* d_out, int* idx_out, unsigned* stats, void* stream) {
  return launch(query, points, B, S, N, K, d_out, idx_out, stats,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
