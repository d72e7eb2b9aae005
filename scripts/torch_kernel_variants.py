"""Time design alternatives of the port's FPS and kNN kernels on a CUDA card.

    python3 scripts/torch_kernel_variants.py

Each alternative is the committed source (``upp_torch/csrc/{fps,knn}.cu``)
with one change, made here by text substitution and built with the port's
own ``nvcc`` flags into ``build/upp_torch/variants/``:

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
                    (committed: the sorted candidates taken as they are).

At the robust path's shapes (batch 120, the synthetic clouds of
``chip_smoke.py``) every alternative must give the committed kernel's
indices; then committed and alternative are timed in turns (committed,
alternative, alternative, committed) by ``torch.profiler``'s device time of
the kernel, mean of 20 launches each. First it prints the committed
kernels' device time at every FPS and kNN shape of ``chip_smoke.py``'s
paths, which CUDA events cannot show where the wrapper's host cost is the
longer.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

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


def device_us(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "_kernel" in e.key) / reps


def in_turns(committed, variant):
    t = [device_us(f) for f in (committed, variant, variant, committed)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def committed_device_times(clouds, gen, card):
    """Device µs per launch of the committed kernels, through their
    wrappers, at every FPS and kNN shape of the paths."""
    from chip_smoke import kernel_shapes
    from upp_torch.ops import fps_cuda, knn_cuda
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
            continue
        print(f"[device] {call}: {device_us(fn):.1f} us per launch (B={bsz}; {card})",
              flush=True)


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


def knn_variants(clouds, card):
    from upp_torch.ops import knn_cuda
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {"per-chunk": build("knn_per_chunk", substituted("knn", KNN_PER_CHUNK)),
            "no-cap": build("knn_no_cap", substituted("knn", KNN_NO_CAP)),
            "merge-first": build("knn_merge_first", substituted("knn", KNN_MERGE_FIRST))}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, synthetic_clouds
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    clouds = torch.from_numpy(synthetic_clouds(B)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        committed_device_times(clouds, gen, card)
        fps_variants(clouds, gen, card)
        knn_variants(clouds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
