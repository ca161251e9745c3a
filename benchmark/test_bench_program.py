"""The program's own view of a traced run (``harness/program.py``,
``program_view.py``) on the CPU: the reduction by the program's ranges on
synthetic Chrome traces, that ``reduce_events`` reads the same with the
program's ranges in the trace, the rebuilt decode bytes, each reading on
a synthetic context (and None where the program lacks what it reads),
and the hooks around both drivers at a tiny size."""

from __future__ import annotations

import time

import pytest

from benchmark import program_view
from benchmark.harness import flops, program, trace
from benchmark.test_bench_drivers import (LLAMA, SERVE_LIMITS, SERVE_MIX, TINY, TRAIN_LIMITS,
                                          TRAIN_MIX)

D = LLAMA.Dims(name="tiny", mlp_dim=192, **TINY)


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _kernel(corr, launched, dur, tid=1):
    """A launch at ``launched`` and its kernel, running from 1 us later."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launched,
             "dur": 1, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": "ampere_sgemm", "ts": launched + 1,
             "dur": dur, "args": {"correlation": corr}}]


def _trace():
    """train.step [0, 100] holds train.forward_backward [10, 60], which holds
    moe.forward [20, 30], then train.optimizer [70, 90]; the harness's range
    around the optimizer [69, 91]; one kernel launched before every range,
    one from another thread inside forward_backward; a last train.optimizer
    [95, 98] in which the profiler stopped (its synchronise at 96), as it
    did in train.step."""
    events = [_range("train.step", 0, 100), _range("train.forward_backward", 10, 50),
              _range("moe.forward", 20, 10), _range("train.optimizer", 70, 20),
              _range("optimizer (AdamW.update)", 69, 22), _range("train.optimizer", 95, 3),
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 96,
               "dur": 1, "tid": 1, "args": {}}]
    events += _kernel(1, -5, 7)  # outside every range
    events += _kernel(2, 5, 2)  # train.step alone
    events += _kernel(3, 15, 3)  # forward_backward
    events += _kernel(4, 25, 4)  # moe.forward, inside both
    events += _kernel(5, 40, 5, tid=2)  # the backward's thread: forward_backward
    events += _kernel(6, 80, 6)  # optimizer, inside the harness's range too
    return events


def test_kernels_go_to_the_innermost_program_range():
    got = program.reduce_ranges(_trace(), exclude=("optimizer (AdamW.update)",))
    assert got["range_s"] == pytest.approx({
        trace.OUTSIDE: 7e-6, "train.step": 2e-6, "train.forward_backward": 8e-6,
        "moe.forward": 4e-6, "train.optimizer": 6e-6})
    assert got["launches"] == {trace.OUTSIDE: 1, "train.step": 1,
                               "train.forward_backward": 2, "moe.forward": 1,
                               "train.optimizer": 1}
    assert got["count"] == {"train.step": 1, "train.forward_backward": 1, "moe.forward": 1,
                            "train.optimizer": 2}
    assert got["whole"] == {"train.forward_backward": 1, "moe.forward": 1,
                            "train.optimizer": 1}
    assert got["whole_s"] == pytest.approx({"train.forward_backward": 8e-6,
                                            "moe.forward": 4e-6, "train.optimizer": 6e-6})
    alone = program.reduce_ranges(_trace())  # the harness's range, opened first, is outer
    assert alone["range_s"]["train.optimizer"] == pytest.approx(6e-6)
    assert "optimizer (AdamW.update)" not in alone["range_s"]


def test_reduce_events_reads_the_same_with_the_programs_ranges_in_the_trace():
    ranges = ("optimizer (AdamW.update)",)
    bare = [e for e in _trace() if e.get("cat") != "user_annotation" or e["name"] in ranges]
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": t, "dur": 3}
            for t in (3, 13, 23)]
    without = trace.reduce_events(bare + host, ranges)
    with_them = trace.reduce_events(_trace() + host, ranges)
    gaps = with_them.pop("idle_gaps")
    assert with_them == {k: v for k, v in without.items() if k != "idle_gaps"}
    # only the gaps' names move: the host waits inside a program range
    assert [g for _, g in gaps] == [g for _, g in without["idle_gaps"]]
    named = dict(zip((n for n, _ in without["idle_gaps"]), (n for n, _ in gaps)))
    assert named["host in python, no op"] != "host in python, no op"
    assert {n for n, _ in gaps} == {"host in aten::mm", "host in train.step",
                                    "host in train.forward_backward", "host in moe.forward"}


def test_decode_bytes_sum_the_steps_bytes():
    steps = [[30, 41], [31, 42, 7], [8]]
    want = sum(LLAMA.decode_step_bytes(D, c) for c in steps)
    got = LLAMA.decode_bytes(D, len(steps), sum(map(len, steps)), sum(map(sum, steps)))
    assert got == want


def _serve_context(program_counters=True, ranged=True):
    window = [{"target_steps": 100, "decode_row_steps": 3000, "decode_kv_tokens": 4_000_000,
               "decode_host_seconds": 1.0, "prefill_stall_seconds": 5.0},
              {"target_steps": 300, "decode_row_steps": 9000, "decode_kv_tokens": 12_000_000,
               "decode_host_seconds": 3.5, "prefill_stall_seconds": 15.0}]
    profiled = [dict(window[0]), {**window[0], "target_steps": 120, "decode_row_steps": 3600,
                                  "decode_kv_tokens": 4_800_000},
                {**window[0], "target_steps": 120, "decode_row_steps": 3600,
                 "decode_kv_tokens": 4_800_000, "decode_host_seconds": 1.5,
                 "prefill_stall_seconds": 7.0}]  # the stop stalled an admission for 2 s
    if not program_counters:  # the parent's engine: no such counters
        window = [{k: w[k] for k in ("target_steps", "decode_row_steps")} for w in window]
        profiled = [{k: w[k] for k in ("target_steps", "decode_row_steps")} for w in profiled]
    ranges = ({"range_s": {"serve.decode_step": 2.05}, "count": {"serve.decode_step": 21},
               "whole": {"serve.decode_step": 20}, "whole_s": {"serve.decode_step": 2.0}}
              if ranged else {"range_s": {}, "count": {}, "whole": {}, "whole_s": {}})
    return {"kind": "serve", "family": LLAMA, "dims": D, "trace": {"program": ranges},
            "program": {"window": window, "profiled": profiled}}


def test_the_serving_readings_and_their_none_cases():
    ctx = _serve_context()
    # the window's 200 steps less the profiled part's 20, with its start and stop
    assert program.prefill_stall_ms(ctx) == pytest.approx((10 - 2) / 180 * 1e3)
    assert program.decode_host_ms(ctx) == pytest.approx((2.5 - 0.5) / 180 * 1e3)
    step_bytes = LLAMA.decode_bytes(D, 20, 600, 800_000) / 20
    assert program.decode_kv_roofline(ctx) == pytest.approx(
        100 * step_bytes / flops.PEAK_BYTES / 0.1)
    parent = _serve_context(program_counters=False, ranged=False)
    for read in (program.prefill_stall_ms, program.decode_host_ms, program.decode_kv_roofline):
        assert read(parent) is None
        assert read({"kind": "serve"}) is None
        assert read({**ctx, "kind": "train"}) is None
    assert program.decode_kv_roofline(_serve_context(ranged=False)) is None


def test_the_grad_norm_reading_and_its_none_cases():
    ctx = {"kind": "train", "trace": {"program": {"whole_s": {"train.grad_norm": 0.06},
                                                  "whole": {"train.grad_norm": 3}}}}
    assert program.grad_norm_ms(ctx) == pytest.approx(20.0)
    assert program.grad_norm_ms({"kind": "train", "trace": {"program": {}}}) is None
    assert program.grad_norm_ms({"kind": "train", "trace": None}) is None
    assert program.grad_norm_ms({"kind": "train", "trace": {"busy_s": 1.0}}) is None


def test_the_view_hooks_around_the_serving_driver():
    from benchmark.harness import serve

    seen = {"edges": [], "profiled": [], "context": None}
    with program_view._hooks(seen):
        serve.run({"name": "tiny"}, LLAMA, D, SERVE_MIX, SERVE_LIMITS, 2**31 + 7, 3.0, True, "cpu",
                  time.monotonic())
    ctx = seen["context"]
    assert len(ctx["program"]["window"]) == 2 and len(ctx["program"]["profiled"]) == 3
    assert program.delta(*ctx["program"]["window"])["target_steps"] > 0
    out = program_view.view(ctx)
    assert set(out["readings"]) == {"prefill_stall_ms.serve", "decode_host_ms.serve",
                                    "decode_kv_roofline.serve"}
    assert out["readings"]["decode_host_ms.serve"] > 0
    assert out["readings"]["prefill_stall_ms.serve"] is not None
    assert out["program_count"].get("serve.emit", 0) > 0
    assert "decode_program" not in out["program_count"]
    assert out["harness_count"].get("decode_program", 0) > 0


def test_the_view_hooks_around_the_training_driver():
    from benchmark.harness import train

    d = LLAMA.Dims(name="tiny", mlp_dim=96, n_experts=4, top_k=2, aux_weight=0.02,
                   capacity_factor=1.25, vocab_chunk=64, **TINY)
    seen = {"edges": [], "profiled": [], "context": None}
    with program_view._hooks(seen):
        train.run({"name": "tiny"}, LLAMA, d, TRAIN_MIX, TRAIN_LIMITS, 2**31 + 7, 0.5, True, "cpu",
                  time.monotonic())
    out = program_view.view(seen["context"])
    steps = seen["context"]["trace"]["steps"]
    assert out["program_count"]["train.grad_norm"] == steps
    assert out["program_count"]["moe.forward"] == steps * d.n_layers
    assert set(out["readings"]) == {"grad_norm_ms.train"}
