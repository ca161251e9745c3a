"""Profiling (``oim_tpu/common/profiling.py``): a ``torch.profiler`` trace
of the hot region, as the JAX package takes a ``jax.profiler`` one.

Usage: ``with profile_trace(dir):`` around the region, or the ``--profile
DIR`` flag of the trainer CLI. The trace (host ops, and the card's kernels
and copies where there is a card) is written to DIR as a Chrome trace
(``chrome://tracing`` or Perfetto), named ``*.trace.json`` so that
``tracing.merge_trace_dir`` over a ``--trace-dir`` that holds it puts it on
one timeline with the spans. An empty DIR is a no-op.
"""

from __future__ import annotations

import contextlib
import os
import time

from oim_tpu_torch.common.logging import from_context


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """torch.profiler wrapper; no-op when trace_dir is falsy, and a logged
    error (not a crash) when the profiler cannot start or write."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    log = from_context()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as err:  # the profiler's own failure, not the program's
        log.error("profiler unavailable; continuing without trace", error=str(err))
        yield
        return
    log.info("profiling", dir=trace_dir)
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"profile.{os.getpid()}.{int(time.time())}.trace.json")
            prof.export_chrome_trace(path)
            log.info("profile written", path=path)
        except Exception as err:  # noqa: BLE001 - the trace is best effort
            log.error("profiler trace finalize failed", error=str(err))
