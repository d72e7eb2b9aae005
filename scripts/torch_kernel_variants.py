"""Time design alternatives of the port's FPS, kNN and Chamfer kernels on a
CUDA card.

    python3 scripts/torch_kernel_variants.py [fps] [knn] [chamfer] [fps-cluster] [knn-select]
        [--parent DIR]

Each alternative is the committed source (``upp_torch/csrc/*.cu``) with one
change, made here by text substitution and built with the port's own
``nvcc`` flags into ``build/upp_torch/variants/``:

  fps  shuffle      the warp argmax as a five-step ``__shfl_xor_sync``
                    butterfly on the packed 64-bit key (committed:
                    ``redux.sync``, two instructions);
  fps  P<p> W<w>    another block shape: p points a thread in w warps, by an
                    entry point appended to the source;
  knn  per-chunk    a bitonic merge after every chunk that has candidates
                    (committed: candidates buffered, a merge per 32);
  knn  no-cap       one block per 8 queries whatever S (committed: at most
                    kMaxBlocks blocks, warps looping over queries);
  knn  merge-first  the first flush merged into the empty kept list too
                    (committed: the sorted candidates taken as they are);
  chamfer kR8, T256, kC8, stage1024
                    8 resident points a thread, 256 threads a block, 8
                    swept points a step, 1024-point stages (committed: 4,
                    128, 4, 512); with the committed, kR8 and T256 also
                    under launch plans of 1024 and 4096 target blocks;
  chamfer shfl-min  the column's warp minimum by a ``__shfl_xor_sync``
                    butterfly (committed: ``redux.sync``);
  chamfer probes    no-column-index, no-column, no-row-index: a part of the
                    work left out, to show its cost (outputs not checked);
  fps-cluster       FPS variant 6 (N > 16384, a cluster of 16 blocks a
                    cloud) at the patch denoiser's shapes at batch 1 (and
                    150000 -> 50000 in random order), timed by CUDA events
                    in turns, indices equal: each part of its design turned
                    off (``pull exchange``: the earlier design's cluster
                    barrier and remote loads a round; ``shared-memory
                    xyz``: the coordinates read from shared memory in every
                    instance; ``no skipping``), other points a thread and
                    warps a
                    block (``P4 W16`` for N <= 32768, ``P24 W13`` and ``P32
                    W12`` past 65536), the ``exchange only`` probe (every
                    warp skips every round: the round's floor; indices not
                    checked) and, with ``--parent``, the parent's variant 6.
                    Prints the committed kernel's share of warp-rounds
                    skipped. Not part of the default set.
  knn-select        the large-k kNN (``csrc/knn_select.cu``) at
                    ``chip_smoke.DENOISE_KNN_CALLS`` on noisy-sphere clouds,
                    timed in turns by the median launch in
                    ``torch.profiler``, outputs equal: each part of its
                    design turned off (``C = 1``: one block a query, where
                    a share fits; the ``__match_any_sync`` histogram; the
                    register and the barrier-a-stage bitonic sorts in place
                    of the merge sort; the radix select over the whole
                    share in place of the candidates), other plans (threads,
                    ``C`` doubled and halved, the smallest share, the
                    register cap), the probes that end the kernel after
                    each phase (outputs not checked; ``after the merged
                    histogram`` is the floor: the distance pass and one
                    merged histogram) and, with ``--parent``, the parent's
                    kernel. Not part of the default set.

At the robust path's shapes (batch 120, the synthetic clouds of
``chip_smoke.py``; Chamfer at the pretask shapes, batch 64) every
alternative must give the committed kernel's outputs; then committed and
alternative are timed in turns (committed, alternative, alternative,
committed) by ``torch.profiler``'s device time, mean of 20 launches each
(Chamfer: every device event of a call, the key reset included). First it
prints the committed kernels' device time at every shape of
``chip_smoke.py``'s paths, which CUDA events cannot show where the
wrapper's host cost is the longer.

``--parent DIR`` names an unpacked checkout of an earlier commit (for
example ``git archive <commit> | tar -x -C archive/parent``): its kNN kernel
is timed against the committed one in the same turns at every kNN shape
above (the k <= 32 instance), outputs equal; with ``fps-cluster``, its FPS
kernel's variant 6 against the committed one; its Chamfer kernel and wrapper
are timed against the committed ones in the same turns, through both
wrappers by CUDA events too, and swapped into the pretask eval and train
steps to compare their device-busy time.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import types
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")

B = 120
FPS_SHAPES = {(8192, 1024, True): [(16, 16)],
              (1228, 1024, False): [(8, 5), (16, 3), (32, 2)],
              (1024, 256, False): [(8, 4), (16, 2)]}
KNN_SHAPES = ((64, 1024, 32, True), (32, 1096, 16, True), (1096, 32, 16, False),
              (64, 32, 8, False), (1024, 8192, 16, False))

FPS_SHUFFLE = ("""  const unsigned m = __reduce_max_sync(kFull, hi);
  lo = __reduce_max_sync(kFull, hi == m ? lo : 0u);
  hi = m;""", """  unsigned long long k = (static_cast<unsigned long long>(hi) << 32) | lo;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, k, s);
    k = o > k ? o : k;
  }
  hi = static_cast<unsigned>(k >> 32);
  lo = static_cast<unsigned>(k);""")
FPS_SHAPE_ENTRY = """
extern "C" int upp_fps_shape(const float* xyz, const float* init, int B, int N, int S,
                             int* idx_out, int P, int warps, void* stream) {
  FpsKernel k = P == 4 ? fps_kernel<4, true> : P == 8 ? fps_kernel<8, true>
              : P == 16 ? fps_kernel<16, true> : P == 32 ? fps_kernel<32, true> : nullptr;
  if (k == nullptr || warps * 32 * P < N) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) * 3 * warps * 32 * P;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<B, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(xyz, init, N, S, idx_out);
  return static_cast<int>(cudaGetLastError());
}
"""
KNN_PER_CHUNK = ("      count += __popc(mask);\n", "      count += __popc(mask);\n      flush();\n")
KNN_NO_CAP = ("constexpr int kMaxBlocks = 2048;", "constexpr int kMaxBlocks = 1 << 30;")
KNN_MERGE_FIRST = ("best = merged ? warp_merge(best, sorted, lane) : sorted;",
                   "best = warp_merge(best, sorted, lane);")


def substituted(name, *edits, append=""):
    from upp_torch.ops import cuda_build
    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu: the text to replace is not there once: {old!r}")
        text = text.replace(old, new)
    return text + append


def build(tag, source):
    from upp_torch.ops import cuda_build
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
    src.write_text(source)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {tag} failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def device_us(fn, reps=20, kernel=None):
    """Device µs a call: the device time of its kernels (every one named
    ``*_kernel*``) over ``reps`` calls. With ``kernel``, the median µs of
    a launch of the kernel of that name, by ``chip_smoke.kernel_device_us``
    (robust to the launches the profiler drops)."""
    if kernel is not None:
        from chip_smoke import kernel_device_us
        return kernel_device_us(fn, kernel, reps)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "_kernel" in e.key) / reps


def in_turns(committed, variant, timer=None):
    timer = timer or device_us
    t = [timer(f) for f in (committed, variant, variant, committed)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def committed_device_times(clouds, gen, card):
    """Device µs per launch of the committed kernels, through their
    wrappers, at every FPS and kNN shape of the paths."""
    from chip_smoke import kernel_shapes
    from upp_torch.ops import chamfer_cuda, fps_cuda, knn_cuda
    from upp_torch.ops.corrupt import _crop_masks
    for call, bsz in kernel_shapes():
        batch = clouds[:bsz]
        if call[0] == "knn":
            _, s, n, k, gather = call
            points, query = batch[:, :n].contiguous(), batch[:, :s].contiguous()

            def fn():
                return knn_cuda.knn(query, points, k, gather)
        elif call[0] == "fps":
            _, n, s, masked = call
            xyz = batch[:, :n].contiguous()
            valid = start = None
            if masked:
                d, crop = _crop_masks(xyz, n // 4, None, gen)
                valid = ~crop
                start = torch.where(valid, d, torch.inf).argmin(1)

            def fn():
                return fps_cuda.fps_idx(xyz, s, valid, start)
        else:
            _, n, m, _ = call
            x, y = torch.roll(batch, 1, 0)[:, :n].contiguous(), batch[:, :m].contiguous()
            print(f"[device] {call}: {chamfer_device_us(lambda: chamfer_cuda.nn_both(x, y)):.1f} "
                  f"us per call, key reset + fused + unpack (B={bsz}; {card})", flush=True)
            continue
        print(f"[device] {call}: {device_us(fn):.1f} us per launch (B={bsz}; {card})",
              flush=True)
    select_device_times(card)


def select_device_times(card):
    """Device µs per launch of the large-k kNN through its wrapper at
    ``chip_smoke.DENOISE_KNN_CALLS`` (noisy-sphere clouds), with its plan."""
    from chip_smoke import DENOISE_KNN_CALLS, scan_cloud
    from upp_torch.ops import knn_cuda
    for i, (bsz, s, n, k) in enumerate(DENOISE_KNN_CALLS):
        points = torch.stack([scan_cloud(n, 100 + 10 * i + b, "cuda") for b in range(bsz)])
        query = points[:, :s].contiguous()
        us = select_us(lambda: knn_cuda.knn_select(query, points, k))
        print(f"[device] knn_select (B={bsz}, S={s}, N={n}, k={k}): {us:.1f} us per launch, "
              f"plan (blocks a query, threads, digits kept) "
              f"{knn_cuda.select_plan(bsz * s, n)} ({card})", flush=True)


def fps_variants(clouds, gen, card):
    from upp_torch.ops import fps_cuda
    from upp_torch.ops.corrupt import _crop_masks
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shuffle = build("fps_shuffle", substituted("fps", FPS_SHUFFLE)).upp_fps
    shuffle.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr]
    shapes = build("fps_shapes", substituted("fps", append=FPS_SHAPE_ENTRY)).upp_fps_shape
    shapes.argtypes = [ptr, ptr, i32, i32, i32, ptr, i32, i32, ptr]
    committed = fps_cuda._lib().upp_fps
    for (n, s, masked), block_shapes in FPS_SHAPES.items():
        xyz = clouds[:, :n].contiguous()
        init = torch.full((B, n), 1e10, device=xyz.device)
        if masked:
            d, crop = _crop_masks(xyz, n // 4, None, gen)
            init = torch.where(crop, -1.0, 1e10).float().contiguous()
            init.scatter_(1, torch.where(~crop, d, torch.inf).argmin(1, keepdim=True), 2e10)
        want = torch.empty((B, s), dtype=torch.int32, device=xyz.device)
        got = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream
        args = (xyz.data_ptr(), init.data_ptr(), B, n, s)

        def run(fn, out, *extra):
            def go():
                err = fn(*args, out.data_ptr(), *extra, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed ({err})")
            return go
        base = run(committed, want)
        alternatives = [("shuffle", run(shuffle, got))]
        alternatives += [(f"P{p} W{w}", run(shapes, got, p, w)) for p, w in block_shapes]
        base()
        for name, fn in alternatives:
            fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fps {name} at {n}->{s}: indices differ")
            c, v = in_turns(base, fn)
            print(f"[fps variant] {n}->{s} masked={masked}: committed "
                  f"(variant {fps_cuda.variant(n)}) {c:.1f} us, {name} {v:.1f} us "
                  f"(B={B}; {card})", flush=True)


# (N, S, layout): the patch denoiser's calls at batch 1 (utils/denoise.py;
# the re-sampling 3N -> N on the patch layout it gets, the seed FPS on the
# noisy cloud), 150000 -> 50000 again in random order, 16385 and the limit
FPS_CLUSTER_SHAPES = ((16385, 512, "random"), (30000, 10000, "patches"), (50000, 150, "random"),
                      (150000, 50000, "patches"), (150000, 50000, "random"),
                      (262144, 1024, "random"))
# each of the design's three parts turned off, other instance shapes, and
# the exchange-only probe (no point work: the round's floor)
FPS_CLUSTER_PUSH = """      if (lane < kClusterBlocks) {
        const int j = static_cast<int>(~lo) - base;
        push_candidate(&cand[i & 1][rank], &bar[i & 1], lane,
                       Candidate{lo, hi, sx[j], sy[j], sz[j]});
      }
    }
    wait_round(&bar[i & 1], (i >> 1) & 1);
    if (tid == 0) expect_round(&bar[i & 1]);  // its next phase: round i + 2
    Candidate c{0u, 0u, 0.f, 0.f, 0.f};
    if (lane < kClusterBlocks) c = cand[i & 1][lane];"""
FPS_CLUSTER_PULL = """      if (lane == 0) {
        const int j = static_cast<int>(~lo) - base;
        cand[i & 1][0] = Candidate{lo, hi, sx[j], sy[j], sz[j]};
      }
    }
    cluster.sync();
    Candidate c{0u, 0u, 0.f, 0.f, 0.f};
    if (lane < kClusterBlocks) c = *cluster.map_shared_rank(&cand[i & 1][0], lane);"""
FPS_CLUSTER_SKIP = "    if ((__float_as_uint(lb) | 0x80000000u) < whi) {"
FPS_CLUSTER_P8 = "{fps_cluster_kernel<8, 16, true>, 8, 16, true}"
FPS_CLUSTER_P16 = "{fps_cluster_kernel<16, 20, true>, 16, 20, true}"
FPS_CLUSTER_EXACT = {
    "pull exchange": ((FPS_CLUSTER_PUSH, FPS_CLUSTER_PULL),),
    "shared-memory xyz": ((FPS_CLUSTER_P8, FPS_CLUSTER_P8.replace("true", "false")),
                          (FPS_CLUSTER_P16, FPS_CLUSTER_P16.replace("true", "false"))),
    "no skipping": ((FPS_CLUSTER_SKIP, "    if (true) {"),),
    "P4 W16": ((FPS_CLUSTER_P8, "{fps_cluster_kernel<4, 16, true>, 4, 16, true}"),),
    "P24 W13": ((FPS_CLUSTER_P16, "{fps_cluster_kernel<24, 13, true>, 24, 13, true}"),),
    "P32 W12": ((FPS_CLUSTER_P16, "{fps_cluster_kernel<32, 12, true>, 32, 12, true}"),),
}
FPS_CLUSTER_PROBES = {
    "exchange only": ((FPS_CLUSTER_SKIP, "    if (false) {"),),
}


def build_all(sources, kernel="fps_cluster_kernel"):
    """``build`` of every (tag, source) at once, one ``nvcc`` each, in
    parallel; prints each library's ptxas resource lines of ``kernel``."""
    from upp_torch.ops import cuda_build
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, source in sources.items():
        src, lib = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
        src.write_text(source)
        procs[tag] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tag} failed:\n{log}")
        for line in cuda_build._ptxas_usage(log).split("; "):
            if kernel in line:
                print(f"[ptxas] {tag}: {line}", flush=True)
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def fps_cluster_cloud(n, layout, seed):
    """[1, n, 3] on the card: a noisy sphere cloud (``random``: the points in
    random order), or ``patches``: the re-sampling input of
    ``patch_based_denoise`` on a cloud of n / 3 points."""
    from chip_smoke import patch_cloud, scan_cloud
    if layout == "patches":
        return patch_cloud(n // 3, seed, "cuda")
    return scan_cloud(n, seed, "cuda")[None].contiguous()


def fps_cluster_variants(card, parent_dir=None):
    """FPS variant 6 against its alternatives (and the parent commit's, with
    ``parent_dir``) at ``FPS_CLUSTER_SHAPES``, CUDA events in turns
    (committed, alternative, alternative, committed); indices equal to the
    committed kernel's, except the probe's. Prints ms and µs a round, and
    the committed kernel's share of warp-rounds skipped."""
    from upp_torch.ops import fps_cuda
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    sources = {f"fps_cluster_{name.replace(' ', '_').replace('-', '_')}":
               substituted("fps", *edits)
               for name, edits in {**FPS_CLUSTER_EXACT, **FPS_CLUSTER_PROBES}.items()}
    names = list(FPS_CLUSTER_EXACT) + list(FPS_CLUSTER_PROBES)
    if parent_dir:
        sources["fps_parent"] = (Path(parent_dir) / "upp_torch" / "csrc" / "fps.cu").read_text()
        names.append("parent")
    libs = list(build_all(sources).values())
    fns = {name: lib.upp_fps for name, lib in zip(names, libs)}
    for fn in fns.values():
        fn.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr]
    committed = fps_cuda._lib().upp_fps
    for seed, (n, s, layout) in enumerate(FPS_CLUSTER_SHAPES):
        xyz = fps_cluster_cloud(n, layout, seed)
        want = torch.empty((1, s), dtype=torch.int32, device="cuda")
        got = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn, out):
            def go():
                err = fn(xyz.data_ptr(), None, 1, n, s, out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"launch failed ({err})")
            return go
        base = run(committed, want)
        base()
        _, skipped, total = fps_cuda.cluster_skip_stats(xyz, s)
        print(f"[fps-cluster] {n}->{s} {layout}: instance {fps_cuda.cluster_shape(n)}, "
              f"{skipped} of {total} warp-rounds skipped ({skipped / max(total, 1):.4f}) "
              f"(B=1; {card})", flush=True)
        reps = max(1, min(20, 20000 // s))
        for name, fn in fns.items():
            alt = run(fn, got)
            alt()
            torch.cuda.synchronize()
            exact = name not in FPS_CLUSTER_PROBES
            if exact and not torch.equal(got, want):
                raise AssertionError(f"fps-cluster {name} at {n}->{s} {layout}: indices differ")
            c, v = in_turns(base, alt, lambda f: events_ms(f, reps))
            print(f"[fps-cluster variant] {n}->{s} {layout}: committed {c:.3f} ms, {name} "
                  f"{v:.3f} ms, {c / (s - 1) * 1e3:.3f} / {v / (s - 1) * 1e3:.3f} us a round"
                  f"{'' if exact else ' (probe: indices not checked)'} (B=1; {card})",
                  flush=True)


# the large-k kNN (csrc/knn_select.cu): each part of its design turned off,
# built by substitution; every one must give the committed kernel's outputs
SELECT_SORT_CALL = "block_sort<kThreads>(keys, spare, n);"
SELECT_SORT_DEF = "template <int kThreads>\n__device__ Key* block_sort("
# the gathered keys sorted by a bitonic network in registers: strides < 32
# by __shfl_xor_sync, strides >= the block's threads inside a thread, a
# barrier at each stride between (15 at 1024 keys and 1024 threads)
SELECT_REGISTER_BITONIC = r"""__device__ __forceinline__ Key keep(Key v, Key o, int i, int stride,
                                     int width) {
  const bool low = (i & stride) == 0;
  const bool up = (i & width) == 0;
  return (low == up) ? (o < v ? o : v) : (o > v ? o : v);
}

template <int kThreads>
__device__ Key* register_bitonic(Key* keys, Key* spare, int n) {
  constexpr int E = kGathered / kThreads;
  const int tid = threadIdx.x;
  int size = 32;
  while (size < n) size <<= 1;
  Key v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * kThreads + tid;
    v[e] = i < n ? keys[i] : ~0ull;
  }
  int phase = 0;
  for (int width = 2; width <= size; width <<= 1) {
    for (int stride = width >> 1; stride > 0; stride >>= 1) {
      if (stride >= kThreads) {
        const int es = stride / kThreads;
#pragma unroll
        for (int e = 0; e < E; ++e) {
#pragma unroll
          for (int f = e + 1; f < E; ++f) {
            if ((e & es) == 0 && f == (e | es) && e * kThreads < size) {
              const bool up = ((e * kThreads + tid) & width) == 0;
              const Key a = v[e], c = v[f];
              if ((a > c) == up) {
                v[e] = c;
                v[f] = a;
              }
            }
          }
        }
      } else if (stride >= 32) {
        Key* buf = (phase++ & 1) ? spare : keys;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e * kThreads < size) buf[e * kThreads + tid] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * kThreads + tid;
          if (e * kThreads < size) v[e] = keep(v[e], buf[i ^ stride], i, stride, width);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * kThreads + tid;
          if (e * kThreads < size)
            v[e] = keep(v[e], __shfl_xor_sync(kFull, v[e], stride), i, stride, width);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e * kThreads < size) keys[e * kThreads + tid] = v[e];
  __syncthreads();
  return keys;
}

"""
# the gathered keys sorted by a bitonic network in shared memory, a barrier
# at each of its stages (55 at 1024 keys, 66 at 2048)
SELECT_SHARED_BITONIC = r"""template <int kThreads>
__device__ Key* shared_bitonic(Key* keys, Key* spare, int n) {
  const int tid = threadIdx.x;
  int size = 1;
  while (size < n) size <<= 1;
  for (int i = n + tid; i < size; i += kThreads) keys[i] = ~0ull;
  for (int width = 2; width <= size; width <<= 1) {
    for (int stride = width >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < size; i += kThreads) {
        const int partner = i ^ stride;
        if (partner > i) {
          const Key a = keys[i], c = keys[partner];
          if ((a > c) == ((i & width) == 0)) {
            keys[i] = c;
            keys[partner] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  return keys;
}

"""
# the histogram's count warp-aggregated: one atomicAdd a run of equal digits
SELECT_MATCH_ANY_COUNT = """  const unsigned peers = __match_any_sync(kFull, digit);
  if (digit != kNoDigit && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));"""
SELECT_EXACT = {
    "C = 1": (("constexpr int kMaxCluster = 16;", "constexpr int kMaxCluster = 1;"),
              ("static_assert(kMaxCluster * kMaxStoredShare >= kMaxN,",
               "static_assert(kMaxCluster * kMaxStoredShare >= kMaxN || kMaxCluster == 1,")),
    "match_any histogram": (("  if (digit != kNoDigit) atomicAdd(&hist[digit], 1u);",
                             SELECT_MATCH_ANY_COUNT),),
    "register bitonic sort": (
        (SELECT_SORT_DEF, SELECT_REGISTER_BITONIC + SELECT_SORT_DEF),
        (SELECT_SORT_CALL,
         "register_bitonic<kThreads>(keys, spare, n);")),
    "barrier-a-stage sort": (
        (SELECT_SORT_DEF, SELECT_SHARED_BITONIC + SELECT_SORT_DEF),
        (SELECT_SORT_CALL, "shared_bitonic<kThreads>(keys, spare, n);")),
    "whole-share select": (("while (s.count > static_cast<unsigned>(kCandidates)) {",
                            "while (s.shift > 0) {"),),
    "256 threads": (("return {c, few ? 1024 : 256, share};", "return {c, 256, share};"),),
    "1024 threads": (("return {c, few ? 1024 : 256, share};", "return {c, 1024, share};"),),
    "C x2": (("  const long long room = few ? kSMs : kTargetBlocks;",
              "  const long long room = 2 * (few ? kSMs : kTargetBlocks);"),),
    "C /2": (("  const long long room = few ? kSMs : kTargetBlocks;",
              "  const long long room = (few ? kSMs : kTargetBlocks) / 2;"),),
    "min share 2048": (("constexpr int kMinShare = 512;", "constexpr int kMinShare = 2048;"),),
    "no register cap": (("__launch_bounds__(kThreads, kThreads == 256 ? 5 : 1)",
                         "__launch_bounds__(kThreads)"),),
    "C /2, no register cap": (("  const long long room = few ? kSMs : kTargetBlocks;",
                               "  const long long room = (few ? kSMs : kTargetBlocks) / 2;"),
                              ("__launch_bounds__(kThreads, kThreads == 256 ? 5 : 1)",
                               "__launch_bounds__(kThreads)")),
}
# probes: the kernel cut short after a phase (outputs not checked); "after
# the merged histogram" is the round's floor, the distance pass and one
# merged histogram
# a probe's end: every block leaves after a cluster barrier, so none leaves
# while a peer may still read its shared memory
SELECT_PROBE_END = "\n  if (K > 0) {\n    cluster.sync();\n    return;\n  }"
SELECT_PROBES = {
    "after the launch barrier": (
        ("cluster.sync();  // every block zeroed and running before any remote access",
         "cluster.sync();  // every block zeroed and running before any remote access\n"
         "  if (K > 0) return;"),),
    "after pass 1": (
        ("  __syncthreads();\n  if (rank != 0) push_bins(cluster, u.hist, kTopBins);",
         "  __syncthreads();\n  if (K > 0) return;\n"
         "  if (rank != 0) push_bins(cluster, u.hist, kTopBins);"),),
    "after the merged histogram": (
        ("cluster.sync();  // the cluster's first-digit histogram is in rank 0's",
         "cluster.sync();  // the cluster's first-digit histogram is in rank 0's\n"
         "  if (K > 0) return;"),),
    "after the boundary": (
        ("Select s = *cluster.map_shared_rank(&sel, 0);",
         "Select s = *cluster.map_shared_rank(&sel, 0);" + SELECT_PROBE_END),),
    "after pass 2": (
        ("  const Key* run = block_sort<kThreads>(keys, spare, n);",
         SELECT_PROBE_END + "\n  const Key* run = block_sort<kThreads>(keys, spare, n);"),),
    "after the sorts": (
        ("  cluster.sync();  // every block's keys are sorted",
         "  cluster.sync();  // every block's keys are sorted\n  if (K > 0) return;"),),
    "after the copies": (
        ("  cluster_arrive();  // this block reads no peer's shared memory any more",
         "  cluster_arrive();  // this block reads no peer's shared memory any more\n"
         "  if (K > 0) {\n    cluster_wait();\n    return;\n  }"),),
}


def select_us(fn):
    return device_us(fn, kernel="knn_select_kernel")


def select_variants(card, parent_dir=None):
    """The large-k kNN against its alternatives and probes (and the parent
    commit's kernel, with ``parent_dir``) at ``chip_smoke.DENOISE_KNN_CALLS``
    on noisy-sphere clouds, device µs in turns (committed, alternative,
    alternative, committed); outputs equal to the committed kernel's, except
    the probes'."""
    from chip_smoke import DENOISE_KNN_CALLS, scan_cloud
    from upp_torch.ops import knn_cuda
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    sources = {f"select_{i}": substituted("knn_select", *edits)
               for i, edits in enumerate({**SELECT_EXACT, **SELECT_PROBES}.values())}
    names = list(SELECT_EXACT) + list(SELECT_PROBES)
    if parent_dir:
        sources["select_parent"] = (Path(parent_dir) / "upp_torch" / "csrc"
                                    / "knn_select.cu").read_text()
    libs = build_all(sources, "knn_select_kernel")
    fns = {name: libs[f"select_{i}"].upp_knn_select for i, name in enumerate(names)}
    for fn in fns.values():
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    parent = None
    if parent_dir:
        # an entry point that exports upp_knn_select_smem_max_n takes a global
        # scratch row a query past that N before the outputs; the others a
        # null stats row after them
        parent = libs["select_parent"]
        parent_scratch = hasattr(parent, "upp_knn_select_smem_max_n")
        parent.upp_knn_select.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    committed = knn_cuda._select_lib().upp_knn_select
    for i, (bsz, s, n, k) in enumerate(DENOISE_KNN_CALLS):
        points = torch.stack([scan_cloud(n, 100 + 10 * i + b, "cuda") for b in range(bsz)])
        query = points[:, :s].contiguous()
        outs = [(torch.empty((bsz, s, k), device="cuda"),
                 torch.empty((bsz, s, k), dtype=torch.int32, device="cuda")) for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn, out, before=(), after=(None,)):
            def go():
                err = fn(query.data_ptr(), points.data_ptr(), bsz, s, n, k, *before,
                         out[0].data_ptr(), out[1].data_ptr(), *after, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed ({err})")
            return go
        base = run(committed, outs[0])
        base()
        cases = [(name, run(fn, outs[1]), name in SELECT_EXACT) for name, fn in fns.items()]
        if parent is not None:
            ends = {}
            if parent_scratch:
                big = n > parent.upp_knn_select_smem_max_n()
                scratch = torch.empty((bsz * s, n) if big else (1,), dtype=torch.int32,
                                      device="cuda")
                ends = {"before": (scratch.data_ptr() if big else None,), "after": ()}
            cases.append(("parent", run(parent.upp_knn_select, outs[1], **ends), True))
        plan = knn_cuda.select_plan(bsz * s, n)
        for name, fn, exact in cases:
            if name == "C = 1" and n > knn_cuda.SELECT_MAX_STORED_SHARE:
                print(f"[select variant] (B={bsz}, S={s}, N={n}, k={k}): C = 1 not run, one "
                      f"block's share past {knn_cuda.SELECT_MAX_STORED_SHARE} points", flush=True)
                continue
            for t in outs[1]:
                t.fill_(-1)
            fn()
            torch.cuda.synchronize()
            if exact and not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"knn_select {name} at {(bsz, s, n, k)}: outputs differ")
            c, v = in_turns(base, fn, select_us)
            print(f"[select variant] (B={bsz}, S={s}, N={n}, k={k}) plan {plan}: committed "
                  f"{c:.1f} us, {name} {v:.1f} us"
                  f"{'' if exact else ' (probe: outputs not checked)'} ({card})", flush=True)


def knn_variants(clouds, card, parent_dir=None):
    from upp_torch.ops import knn_cuda
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {"per-chunk": build("knn_per_chunk", substituted("knn", KNN_PER_CHUNK)),
            "no-cap": build("knn_no_cap", substituted("knn", KNN_NO_CAP)),
            "merge-first": build("knn_merge_first", substituted("knn", KNN_MERGE_FIRST))}
    if parent_dir:
        libs["parent"] = build("knn_parent",
                               (Path(parent_dir) / "upp_torch" / "csrc" / "knn.cu").read_text())
    fns = {name: lib.upp_knn for name, lib in libs.items()}
    committed = knn_cuda._lib().upp_knn
    for fn in fns.values():
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    for s, n, k, gather in KNN_SHAPES:
        points, query = clouds[:, :n].contiguous(), clouds[:, :s].contiguous()
        outs = [(torch.empty((B, s, k), device=points.device),
                 torch.empty((B, s, k), dtype=torch.int32, device=points.device),
                 torch.empty((B, s, k, 3), device=points.device) if gather else None)
                for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn, out):
            def go():
                err = fn(query.data_ptr(), points.data_ptr(), B, s, n, k, out[0].data_ptr(),
                         out[1].data_ptr(), None if out[2] is None else out[2].data_ptr(),
                         stream)
                if err != 0:
                    raise RuntimeError(f"launch failed ({err})")
            return go
        base = run(committed, outs[0])
        base()
        for name, fn in fns.items():
            alt = run(fn, outs[1])
            alt()
            torch.cuda.synchronize()
            if not all(a is None or torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"knn {name} at {s}x{n} k{k}: outputs differ")
            c, v = in_turns(base, alt)
            print(f"[knn variant] {s}x{n} k{k} gather={gather}: committed {c:.1f} us, "
                  f"{name} {v:.1f} us (B={B}; {card})", flush=True)


CHAMFER_SHAPES = ((32, 1024), (1024, 1024), (2048, 8192), (160, 8192))
B_CHAMFER = 64
# exact alternatives (each must give the committed kernel's outputs), then
# probes that drop a part of the work to show its cost (their outputs differ)
CHAMFER_EXACT = {
    "kR8": (("constexpr int kR = 4;", "constexpr int kR = 8;"),
            ("constexpr int kTileR = 512;", "constexpr int kTileR = 1024;"),
            ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 2)")),
    "T256": (("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
             ("constexpr int kTileR = 512;", "constexpr int kTileR = 1024;"),
             ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 2)")),
    "kC8": (("constexpr int kC = 4;", "constexpr int kC = 8;"),),
    "stage1024": (("constexpr int kStage = 512;", "constexpr int kStage = 1024;"),),
    "shfl-min": (("const float m = __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(low)));",
                  "float m = low;\n#pragma unroll\n        for (int o = 16; o > 0; o >>= 1) "
                  "m = fminf(m, __shfl_xor_sync(kFull, m, o));"),),
}
CHAMFER_PROBES = {
    "no-column-index": (("key[c] = pack(m, __reduce_min_sync(kFull, cand));",
                         "key[c] = pack(m, cand);"),),
    "no-column": (("for (int c = 0; c < kC; ++c) {\n        float v[kR];",
                   "for (int c = 0; c < 0; ++c) {\n        float v[kR];"),),
    "no-row-index": (("step[i] = nb < best[i] ? j0 : step[i];", ""),),
}
CHAMFER_TARGETS = (1024, 4096)


def chamfer_device_us(fn, reps=20):
    """Device µs per call: every device event of the window (the fused and
    unpack kernels and the key reset, or the two direction kernels)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / reps


def parent_chamfer(parent_dir):
    """The parent's Chamfer library and wrapper, from an unpacked checkout of
    the parent commit: its ``chamfer.cu`` built with this tree's flags, its
    ``chamfer_cuda.py`` loaded against that library."""
    root = Path(parent_dir) / "upp_torch"
    lib = build("chamfer_parent", (root / "csrc" / "chamfer.cu").read_text())
    text = (root / "ops" / "chamfer_cuda.py").read_text()
    if text.count("from . import cuda_build") != 1:
        raise RuntimeError("parent chamfer_cuda.py: no single 'from . import cuda_build'")
    module = types.ModuleType("parent_chamfer_cuda")
    module.cuda_build = types.SimpleNamespace(load=lambda name: lib)
    exec(compile(text.replace("from . import cuda_build", ""), "parent_chamfer_cuda.py", "exec"),
         module.__dict__)
    return lib, module.nn_both


def chamfer_variants(clouds, card, parent_dir):
    """At the Chamfer path shapes (batch 64, unmasked): the committed kernel
    against the parent's (``parent_dir``, if given) through both wrappers by
    CUDA events and by device time, then design alternatives, launch plans
    and probes by device time, in turns."""
    from upp_torch.ops import chamfer_cuda
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    alts = {}
    for name, edits in {**CHAMFER_EXACT, **CHAMFER_PROBES}.items():
        fn = build(f"chamfer_{name}", substituted("chamfer", *edits)).upp_chamfer_nn_both
        fn.argtypes = [ptr] * 4 + [i32] * 6 + [ptr] * 6
        alts[name] = fn
    parent_lib = parent_wrapper = None
    if parent_dir:
        parent_lib, parent_wrapper = parent_chamfer(parent_dir)
    committed = chamfer_cuda._lib().upp_chamfer_nn_both
    batch = clouds[:B_CHAMFER]
    for n, m in CHAMFER_SHAPES:
        x = torch.roll(batch, 1, 0)[:, :n].contiguous()
        y = batch[:, :m].contiguous()
        dev = x.device
        outs = [[torch.empty((B_CHAMFER, n), device=dev),
                 torch.empty((B_CHAMFER, n), dtype=torch.int32, device=dev),
                 torch.empty((B_CHAMFER, m), device=dev),
                 torch.empty((B_CHAMFER, m), dtype=torch.int32, device=dev)] for _ in range(2)]
        keys = torch.empty(B_CHAMFER * (n + m), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn, out, plan=None):
            plan = plan or chamfer_cuda.launch_plan(B_CHAMFER, n, m)

            def go():
                err = fn(x.data_ptr(), y.data_ptr(), None, None, B_CHAMFER, n, m,
                         int(plan.swap), plan.splits, plan.split_len, keys.data_ptr(),
                         *[t.data_ptr() for t in out], stream)
                if err != 0:
                    raise RuntimeError(f"launch failed ({err})")
            return go

        base = run(committed, outs[0])
        base()
        cases = []
        if parent_lib is not None:
            parent_fn = parent_lib.upp_chamfer_nn_both

            def parent():
                err = parent_fn(x.data_ptr(), y.data_ptr(), None, None, B_CHAMFER, n, m,
                                *[t.data_ptr() for t in outs[1]], stream)
                if err != 0:
                    raise RuntimeError(f"launch failed ({err})")
            cases.append(("parent", parent, True))
            mine = lambda: chamfer_cuda.nn_both(x, y)  # noqa: E731
            theirs = lambda: parent_wrapper(x, y)      # noqa: E731
            got, want = mine(), theirs()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"chamfer ({n}, {m}): outputs differ from the parent's")
            t = [events_ms(f) for f in (mine, theirs, theirs, mine)]
            print(f"[chamfer wrapper] ({n}, {m}): committed {(t[0] + t[3]) / 2:.4f} ms, parent "
                  f"{(t[1] + t[2]) / 2:.4f} ms a call through each wrapper, CUDA events "
                  f"(B={B_CHAMFER}; {card})", flush=True)
        for name in alts:
            cases.append((name, run(alts[name], outs[1]), name in CHAMFER_EXACT))
        for target in CHAMFER_TARGETS:
            plan = plan_with_target(B_CHAMFER, n, m, target)
            for name in ("committed", "kR8", "T256"):
                fn = committed if name == "committed" else alts[name]
                cases.append((f"{name} target {target} (splits {plan.splits})",
                              run(fn, outs[1], plan), True))
        for name, fn, exact in cases:
            for t in outs[1]:
                t.fill_(-1)
            fn()
            torch.cuda.synchronize()
            if exact and not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"chamfer {name} at ({n}, {m}): outputs differ")
            c, v = in_turns(base, fn, chamfer_device_us)
            print(f"[chamfer variant] ({n}, {m}): committed {c:.1f} us, {name} {v:.1f} us"
                  f"{'' if exact else ' (probe: outputs not checked)'} (B={B_CHAMFER}; {card})",
                  flush=True)


def chamfer_steps(clouds, card, parent_dir, steps=5):
    """Device-busy ms of the pretask eval and train steps (batch 64) with
    the committed Chamfer wrapper and with the parent's swapped in for it,
    in turns, and the Chamfer kernels' share of each: ``torch.profiler``
    over ``steps`` steps after one unprofiled step."""
    from chip_smoke import B_PRETASK, PRETASK_CFG, pretask_setup
    from upp_torch.ops import chamfer_cuda
    from upp_torch.utils.config import cfg_from_yaml_file
    _, parent_wrapper = parent_chamfer(parent_dir)
    config = cfg_from_yaml_file(PRETASK_CFG)
    _, _, train_step, eval_step = pretask_setup(config, clouds.device)
    gt = clouds[:B_PRETASK]
    vp = torch.tensor((1.0, 1.0, 1.0))
    committed = chamfer_cuda.nn_both

    def is_chamfer(key):
        return any(k in key for k in ("nn_fused_kernel", "unpack_kernel")) or (
            "nn_kernel" in key and "knn_kernel" not in key)

    def busy(step, wrapper):
        chamfer_cuda.nn_both = wrapper
        try:
            step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
        finally:
            chamfer_cuda.nn_both = committed
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("Optimizer.")]
        total = sum(e.self_device_time_total for e in events) / 1e3 / steps
        mine = sum(e.self_device_time_total for e in events if is_chamfer(e.key)) / 1e3 / steps
        return total, mine

    for name, step in (("pretask eval", lambda: eval_step(gt, vp)),
                       ("pretask train", lambda: train_step(gt))):
        runs = [busy(step, w) for w in (committed, parent_wrapper, parent_wrapper, committed)]
        print(f"[chamfer steps] {name}: device busy ms/step committed {runs[0][0]:.3f}, "
              f"{runs[3][0]:.3f}; parent {runs[1][0]:.3f}, {runs[2][0]:.3f}; of it Chamfer "
              f"kernels committed {runs[0][1]:.3f}, {runs[3][1]:.3f}; parent {runs[1][1]:.3f}, "
              f"{runs[2][1]:.3f} (B={B_PRETASK}; {card})", flush=True)


def events_ms(fn, reps=20):
    for _ in range(min(reps, 3)):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plan_with_target(B, n, m, target):
    from upp_torch.ops import chamfer_cuda
    saved = chamfer_cuda.TARGET_BLOCKS
    chamfer_cuda.TARGET_BLOCKS = target
    try:
        return chamfer_cuda.launch_plan.__wrapped__(B, n, m)
    finally:
        chamfer_cuda.TARGET_BLOCKS = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, synthetic_clouds
    args = sys.argv[1:]
    parent_dir = None
    if "--parent" in args:
        i = args.index("--parent")
        parent_dir = args[i + 1]
        del args[i:i + 2]
    kernels = set(args) or {"fps", "knn", "chamfer"}
    if kernels == {"fps-cluster"}:
        print(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
              flush=True)
        fps_cluster_variants(card_line(), parent_dir)
        return 0
    if kernels == {"knn-select"}:
        card = card_line()
        print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        with torch.inference_mode():
            select_device_times(card)
            select_variants(card, parent_dir)
        return 0
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    clouds = torch.from_numpy(synthetic_clouds(B)[0]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        committed_device_times(clouds, gen, card)
        if "fps" in kernels:
            fps_variants(clouds, gen, card)
        if "knn" in kernels:
            knn_variants(clouds, card, parent_dir)
        if "chamfer" in kernels:
            chamfer_variants(clouds, card, parent_dir)
    if "chamfer" in kernels and parent_dir:
        chamfer_steps(clouds, card, parent_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
