"""The program's own view of a ``--trace 1`` run: device time under the
ranges the port puts on the profiler's trace (its live spans and its
``tracing.device_range`` blocks: ``serve.admit``, ``serve.decode_step``,
``serve.emit``, ``train.forward_backward``, ``train.grad_norm``,
``train.optimizer``, ``train.feed``, ``moe.forward``), the serving
engine's ``request_stats()`` counters of what runs between its device
programs, and the readings they give.

``trace.reduce_events`` and the per-layer readers do not read any of it
yet (the harness's own ranges do that work): ``benchmark/program_view.py``
runs a cell with this view beside its result line. Every reading returns
None where the program has no such range or counter."""

from __future__ import annotations

import bisect

from benchmark.harness import flops
from benchmark.harness.trace import DEVICE_CATS, LAUNCH_CATS, OUTSIDE

CALL_CATS = ("cpu_op",) + LAUNCH_CATS  # host calls, ranges aside

COUNTERS = ("decode_row_steps", "decode_kv_tokens", "decode_host_seconds",
            "prefill_stall_seconds")


def reduce_ranges(events, exclude=()) -> dict:
    """Chrome trace events -> {"range_s": {range: device seconds},
    "launches": {range: kernels, copies and fills}, "count": {range:
    occurrences}, "whole": {range: whole occurrences}, "whole_s": {range:
    their device seconds}} over the ``user_annotation`` ranges not named
    in ``exclude``. A kernel belongs to the innermost range (the latest to
    start) open at its launch on the host clock, whatever the thread (the
    autograd engine launches the backward's kernels from its own thread
    while the step's thread waits inside its range); the ranges that
    enclose that one do not count it. Kernels launched outside every range
    fall under ``OUTSIDE``. A range open when the profiler stopped is in
    the trace without what it launched after the stop: an occurrence is
    whole when it closed before the trace's last host call (the stop's
    synchronise) began, and a mean an occurrence is taken over those."""
    ranges, launches, device, calls = [], {}, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts = float(ev.get("ts", 0.0))
        if cat == "user_annotation" and ev.get("name") not in exclude:
            ranges.append((ts, ts + float(ev.get("dur", 0.0)), ev["name"]))
        elif cat in DEVICE_CATS:
            device.append(ev)
        elif cat in CALL_CATS:
            calls.append(ts)
            corr = ev.get("args", {}).get("correlation")
            if cat in LAUNCH_CATS and corr is not None:
                launches[corr] = ts
    last_call = max(calls, default=float("inf"))
    ranges.sort()
    count: dict = {}
    for _, _, name in ranges:
        count[name] = count.get(name, 0) + 1
    launched = sorted((launches[c], i) for i, ev in enumerate(device)
                      if (c := ev.get("args", {}).get("correlation")) in launches)
    owner = [None] * len(device)  # the index in ranges of each kernel's range
    starts = [r[0] for r in ranges]
    open_, nxt = [], 0
    for t, i in launched:  # launch times in order; open_ holds the ranges begun by t
        j = bisect.bisect_right(starts, t)
        open_.extend(range(nxt, j))
        nxt = j
        while open_ and ranges[open_[-1]][1] < t:  # ended for every later launch too
            open_.pop()
        if open_:
            owner[i] = open_[-1]
    range_s: dict = {}
    kernels: dict = {}
    whole_s: dict = {}
    for ev, k in zip(device, owner):
        name = OUTSIDE if k is None else ranges[k][2]
        dur = float(ev.get("dur", 0.0)) / 1e6
        range_s[name] = range_s.get(name, 0.0) + dur
        kernels[name] = kernels.get(name, 0) + 1
        if k is not None and ranges[k][1] < last_call:
            whole_s[name] = whole_s.get(name, 0.0) + dur
    whole: dict = {}
    for _, end, name in ranges:
        if end < last_call:
            whole[name] = whole.get(name, 0) + 1
    return {"range_s": range_s, "launches": kernels, "count": count, "whole": whole,
            "whole_s": whole_s}


def engine_counters(stats: dict, request_stats: dict) -> dict:
    """The engine's cumulative counters this view reads, from its
    ``stats()`` and ``request_stats()``: ``target_steps`` and those of
    ``COUNTERS`` that the engine has."""
    out = {"target_steps": stats["target_steps"]}
    out.update({k: request_stats[k] for k in COUNTERS if k in request_stats})
    return out


def delta(before, after) -> dict:
    """``after - before`` of each counter both snapshots hold."""
    return {k: after[k] - before[k] for k in after if k in before}


def _snapshots(run, key: str, n: int) -> list:
    """The ``n`` snapshots of the engine's counters under ``key`` in the
    run's context: "window" (its start and end) or "profiled" (just
    before the profiler's start, just before its stop, just after it)."""
    got = (run.get("program") or {}).get(key) or []
    return got if run.get("kind") == "serve" and len(got) == n else []


def _per_step_ms(run, counter: str):
    """``counter``'s ms a target step over the window less the profiled
    part, from just before the profiler's start to just after its stop:
    the engine waits while the profiler starts and stops on its thread,
    inside whatever it was doing (an admission, say)."""
    window, part = _snapshots(run, "window", 2), _snapshots(run, "profiled", 3)
    if not window or not part:
        return None
    outside = {k: v - delta(part[0], part[2]).get(k, 0)
               for k, v in delta(*window).items()}
    steps = outside.get("target_steps", 0)
    if counter not in outside or steps <= 0:
        return None
    return outside[counter] / steps * 1e3


def prefill_stall_ms(run):
    """Host ms a target step of admissions that prefilled while rows were
    resident (``prefill_stall_seconds``), in the window outside the
    profiled part."""
    return _per_step_ms(run, "prefill_stall_seconds")


def decode_host_ms(run):
    """Host ms a target step of the engine's host turns outside admission
    passes (``decode_host_seconds``), in the window outside the profiled
    part."""
    return _per_step_ms(run, "decode_host_seconds")


def decode_kv_roofline(run):
    """The bytes bound of the profiled part's mean decode step (rebuilt
    from the engine's counters from the profiler's start to its stop) over
    3.35e12 B/s, over the mean device time of the kernels launched under a
    whole ``serve.decode_step`` (the step the profiler started in entered
    its range before the start, and the one it stopped in is cut), in
    %."""
    ranged = (run.get("trace") or {}).get("program") or {}
    snaps = _snapshots(run, "profiled", 3)
    part = delta(*snaps[:2]) if snaps else {}
    steps = part.get("target_steps", 0)
    device_s = ranged.get("whole_s", {}).get("serve.decode_step", 0.0)
    n = ranged.get("whole", {}).get("serve.decode_step", 0)
    if (run.get("kind") != "serve" or not steps or device_s <= 0 or not n
            or "decode_kv_tokens" not in part):
        return None
    step_bytes = run["family"].decode_bytes(run["dims"], steps, part["decode_row_steps"],
                                            part["decode_kv_tokens"]) / steps
    return 100.0 * (step_bytes / flops.PEAK_BYTES) / (device_s / n)


def grad_norm_ms(run):
    """Device ms a step of the kernels launched under ``train.grad_norm``
    (the gradients' global norm for the clip), over the profiled steps."""
    return range_ms(run, "train.grad_norm")


def range_ms(run, name: str):
    """Device ms a whole occurrence of program range ``name`` in the
    profiled part (its innermost kernels only)."""
    ranged = (run.get("trace") or {}).get("program") or {}
    s = ranged.get("whole_s", {}).get(name, 0.0)
    n = ranged.get("whole", {}).get(name, 0)
    return s / n * 1e3 if s > 0 and n else None


READINGS = {"prefill_stall_ms.serve": prefill_stall_ms,
            "decode_host_ms.serve": decode_host_ms,
            "decode_kv_roofline.serve": decode_kv_roofline,
            "grad_norm_ms.train": grad_norm_ms}
