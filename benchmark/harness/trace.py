"""The device trace of a ``--trace 1`` run: ranges the harness wraps
around calls into the program's layers, the profiler, and the reduction
of its Chrome trace to busy time, device time by range and kernel
category, and the longest idle gaps.

A kernel belongs to a range when the host call that launched it (the
runtime event of the same correlation id) lies inside that range on the
profiled thread. The categories copy ``chip_smoke.py``'s grouping of
kernel names, with the paged-decode kernels named apart."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the ranges"


def category(kernel: str) -> str:
    name = kernel.lower()
    if "oimflash" in name:
        return "attention kernels (K1-K3)"
    if "paged_decode" in name:  # paged_decode_split, _merge, _mma
        return "attention kernels (paged decode)"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmuls (cuBLAS)"
    if "reduce" in name or "norm" in name:
        return "reductions"
    if any(k in name for k in ("index", "scatter", "gather", "embedding")):
        return "index, gather and scatter"
    if "memcpy" in name or "memset" in name:
        return "copies and fills"
    return "elementwise and copies"


@contextlib.contextmanager
def patched(owner, attr: str, wrap):
    """Within the block, ``owner.attr`` is ``wrap(the original)``."""
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def in_range(name: str, before=None):
    """A ``patched`` wrap: every call runs under a ``record_function``
    range ``name`` (``before(*args)`` is called first, outside it)."""
    from torch.profiler import record_function

    def wrap(fn):
        def ranged(*a, **k):
            if before is not None:
                before(*a, **k)
            with record_function(name):
                return fn(*a, **k)
        return ranged
    return wrap


class Profiler:
    """``torch.profiler`` over CPU and CUDA activity, started and stopped
    on the thread that runs the program (it records that thread's host
    ops); ``window_s`` is the host clock between the two."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        import torch

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self.prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def reduce(self, path: str, ranges) -> dict:
        """Export the Chrome trace to ``path``, reduce it, delete it."""
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        out = reduce_events(events, ranges)
        out["window_s"] = self.window_s
        return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events, ranges) -> dict:
    """Chrome trace events -> {"busy_s", "device_s": {(range, category):
    seconds}, "range_s": {range: seconds}, "launches": {range: kernels},
    "kernels": {kernel name: [seconds, launches]}, "device_ops": top 10
    [name, s], "idle_gaps": top 10 [name, s]}.
    ``ranges``: the harness's range names."""
    device, launches, spans, host = [], {}, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        if cat == "user_annotation" and ev.get("name") in ranges:
            spans.append((ts, ts + dur, ev["name"]))
        if cat in HOST_CATS:
            host.append((ts, ts + dur, ev.get("name", "?")))
    spans.sort()
    starts = [s[0] for s in spans]

    def range_of(t):  # the harness's ranges never nest
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return spans[i][2]
        return OUTSIDE

    by_key: dict = {}
    range_s: dict = {}
    kernels_in: dict = {}
    by_name: dict = {}
    intervals = []
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        intervals.append((ts, ts + dur))
        launched = launches.get(ev.get("args", {}).get("correlation"))
        rng = OUTSIDE if launched is None else range_of(launched)
        key = (rng, category(ev.get("name", "")))
        by_key[key] = by_key.get(key, 0.0) + dur / 1e6
        range_s[rng] = range_s.get(rng, 0.0) + dur / 1e6
        kernels_in[rng] = kernels_in.get(rng, 0) + 1
        if ev.get("cat") == "kernel":
            got = by_name.setdefault(ev.get("name", ""), [0.0, 0])
            got[0] += dur / 1e6
            got[1] += 1
    merged = _union(intervals)
    busy = sum(b - a for a, b in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    idle = [[f"host in {_host_at(host, (a + b) / 2)}", g / 1e6] for g, a, b in gaps]
    ops = sorted(([f"{r}: {c}", s] for (r, c), s in by_key.items()),
                 key=lambda x: -x[1])[:10]
    return {"busy_s": busy, "device_s": by_key, "range_s": range_s,
            "launches": kernels_in, "kernels": by_name, "device_ops": ops,
            "idle_gaps": idle}


def _host_at(host, t) -> str:
    """The innermost (shortest) host event spanning ``t``."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "python, no op"
