"""Reading ``torch.profiler``: the device's busy time and kernel table over
a profiled stretch of steps, and the idle gaps between device operations
labelled by what the host was doing."""

from __future__ import annotations

import bisect
import time
from collections import Counter
from typing import Callable, Dict, List, Tuple


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile(run: Callable[[], None], sync: Callable[[], None], host: bool = False) -> Dict:
    """``run()`` under the profiler, ``sync()`` after it: device activity
    alone (the host's ops unrecorded, so the host runs near its own pace),
    or with ``host`` the host's ops too, to label the idle gaps. Returns
    {"wall_s", "busy_s", "kernels": {name: (seconds, count)}, "gaps":
    [(host op, seconds)] (with ``host``)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from torch.profiler import supported_activities
    acts = [a for a in [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
            if a in supported_activities()]
    if not acts:                            # a build without CUDA: nothing to trace
        return {"wall_s": 0.0, "busy_s": 0.0, "kernels": {}, "gaps": []}
    sync()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = _dev_us(e)
            if us > 0:
                kernels[e.key] = (us / 1e6, e.count)
    return {"wall_s": wall, "busy_s": sum(s for s, _ in kernels.values()), "kernels": kernels,
            "gaps": _gaps(prof.events(), DeviceType) if host else []}


def _gaps(events, DeviceType) -> List[Tuple[str, float]]:
    """Idle time between consecutive device operations, summed by the host
    op that was running at the gap's start (the innermost aten op, else the
    innermost op)."""
    dev, host = [], []
    for e in events:
        tr = getattr(e, "time_range", None)
        if tr is None:
            continue
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            dev.append((tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    host.sort()
    out = Counter()
    end = None
    starts = [h[0] for h in host]
    for s, e in dev:
        if end is not None and s > end:
            label = _host_at(host, starts, end)
            out[label] += (s - end) / 1e6
        end = e if end is None else max(end, e)
    return out.most_common(10)


def _host_at(host, starts, t) -> str:
    """The innermost host op covering time ``t``, preferring aten ops."""
    best, best_aten = None, None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        s, e, name = host[j]
        if s <= t <= e:
            if best is None or s > best[0]:
                best = (s, name)
            if name.startswith("aten::") and (best_aten is None or s > best_aten[0]):
                best_aten = (s, name)
    pick = best_aten or best
    return pick[1] if pick else "host (no op)"


def top_kernels(kernels: Dict[str, Tuple[float, int]], n: int = 10) -> List[List]:
    return [[k, s] for k, (s, _) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]]
