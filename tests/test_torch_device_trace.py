"""The port's layers on a torch profiler's trace and the serving engine's
counters of what runs between its device programs, on the CPU.

* ``common/tracing.py``: a live span is also a profiler range of its name,
  ``device_range`` marks a block without a ring entry, neither enters
  ``record_function`` while no profiler records, and ``merge_trace_dir``
  puts a ``profile_trace`` export and a span stream on one clock.
* ``ServeEngine`` at llama.tiny: the ``serve.admit``, ``serve.decode_step``
  and ``serve.emit`` ranges, and the ``request_stats()`` counters
  ``decode_kv_tokens`` (held against the live rows' positions that the
  device programs are handed), ``decode_host_seconds`` and
  ``prefill_stall_seconds``, for a plain and a self-draft speculative
  engine.
* ``Trainer`` at llama-tiny-moe: the step's ranges and their nesting.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from oim_tpu_torch.common import tracing
from oim_tpu_torch.common.profiling import profile_trace
from oim_tpu_torch.models import llama
from oim_tpu_torch.serve import ServeEngine
from oim_tpu_torch.serve import engine as tengine
from oim_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ENGINE_RANGES = {"serve.admit", "serve.decode_step", "serve.emit"}


@pytest.fixture
def recorder():
    prev = tracing.recorder()
    rec = tracing.configure("test", capacity=4096)
    yield rec
    rec.close()
    tracing._recorder = prev


def _export(prof, path) -> dict:
    prof.export_chrome_trace(str(path))
    return json.loads(Path(path).read_text())


def _ranges(trace: dict) -> list[tuple[str, float, float]]:
    """(name, start, end) of each user range, on the profiler's clock."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# ------------------------------------------------------------ tracing ----


def test_a_span_and_a_device_range_nest_on_the_profilers_clock(recorder, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.start_span("a") as span:
            with tracing.device_range("b"):
                torch.ones(64) + 1
    trace = _export(prof, tmp_path / "p.json")
    got = {r[0]: r for r in _ranges(trace) if r[0] in ("a", "b")}
    assert set(got) == {"a", "b"} and _inside(got["b"], got["a"])
    start_unix_us = got["a"][1] + trace["baseTimeNanoseconds"] / 1e3
    assert abs(start_unix_us - span.start_unix * 1e6) < 1000
    assert [s.name for s in recorder.spans()] == ["a"]  # the range holds no ring entry


def test_no_profiler_enters_no_record_function(recorder, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with tracing.start_span("a"):
        with tracing.device_range("b"):
            pass
    assert [s.name for s in recorder.spans()] == ["a"]
    with profile(activities=[ProfilerActivity.CPU]):  # recording: the range is entered
        with pytest.raises(AssertionError, match="'b'"):
            with tracing.device_range("b"):
                pass


def test_tracing_neither_imports_torch_nor_needs_it():
    code = ("import sys\n"
            "from oim_tpu_torch.common import tracing\n"
            "with tracing.start_span('a'):\n"
            "    with tracing.device_range('b'):\n"
            "        pass\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert [s.name for s in tracing.recorder().spans()] == ['a']\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr


def test_merge_trace_dir_puts_a_profile_and_the_spans_on_one_clock(tmp_path):
    prev = tracing.recorder()
    rec = tracing.configure("svc", trace_dir=str(tmp_path))
    try:
        with profile_trace(str(tmp_path)):
            with tracing.start_span("merged.op") as span:
                torch.ones(32, 32) @ torch.ones(32, 32)
        rec.flush()
    finally:
        rec.close()
        tracing._recorder = prev
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and all(n.endswith(".trace.json") for n in names)
    merged = tracing.merge_trace_dir(str(tmp_path), str(tmp_path / "all.json"))
    both = {e["cat"]: e for e in merged if e.get("name") == "merged.op"}
    assert set(both) == {"oim", "user_annotation"}
    assert abs(both["oim"]["ts"] - span.start_unix * 1e6) < 1
    assert abs(both["user_annotation"]["ts"] - both["oim"]["ts"]) < 1000
    loaded = json.loads((tmp_path / "all.json").read_text())["traceEvents"]
    assert len(loaded) == len(merged)


# ------------------------------------------------------------- serving ----


@pytest.fixture(scope="module")
def tiny():
    cfg = llama.tiny(vocab=64, dim=32, n_layers=2)
    return llama.init(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg


def _engine(tiny, spec: bool, **kw):
    params, cfg = tiny
    if spec:
        kw.update(draft_params=params, draft_cfg=cfg, spec_tokens=3)
    return ServeEngine(params, cfg, device="cpu", max_seq=128, queue_depth=16, **kw)


SPEC = pytest.mark.parametrize("spec", [False, True], ids=["plain", "self_draft"])


@SPEC
def test_decode_kv_tokens_are_the_live_rows_keys_summed_over_steps(tiny, monkeypatch, spec):
    """Independently of the engine's host counts: at each target program,
    a live row (its table maps a page; an idle row's is all scratch page
    0) attends to its position + 1 keys."""
    name = "verify_program" if spec else "decode_program"
    program = getattr(tengine, name)
    keys, rows = [], []

    def counted(*a, **k):
        pos, tables = a[4], a[7]
        live = tables[:, 0] != 0
        keys.append(int((pos[live] + 1).sum()))
        rows.append(int(live.sum()))
        return program(*a, **k)

    monkeypatch.setattr(tengine, name, counted)
    eng = _engine(tiny, spec, max_batch=2)
    try:
        handles = [eng.submit(p, max_new=n) for p, n in
                   [([1, 2, 3, 4, 5], 17), ([7, 8, 9], 6), ([3] * 11, 9), ([4, 2], 1)]]
        for h in handles:
            h.result(timeout=60)
        st = {**eng.stats(), **eng.request_stats()}
    finally:
        eng.stop(timeout=30)
    assert eng.error is None
    assert st["target_steps"] == len(keys) and st["decode_row_steps"] == sum(rows)
    assert st["decode_kv_tokens"] == sum(keys) > 0


@SPEC
def test_prefill_stall_counts_only_admissions_that_hold_resident_rows(tiny, spec):
    eng = _engine(tiny, spec, max_batch=2)
    try:
        eng.submit([1, 2, 3], max_new=8).result(timeout=60)
        lone = eng.request_stats()
        first = eng.submit([5, 6, 7, 8], max_new=80)
        next(first.tokens(timeout=60))  # resident from here to its last token
        eng.submit([9, 10], max_new=4).result(timeout=60)
        first.result(timeout=60)
        both = eng.request_stats()
    finally:
        eng.stop(timeout=30)
    assert eng.error is None
    assert lone["prefill_stall_seconds"] == 0.0
    assert lone["decode_host_seconds"] > 0.0
    assert both["prefill_stall_seconds"] > 0.0
    assert both["decode_host_seconds"] > lone["decode_host_seconds"]


def test_the_engine_turn_lies_in_its_ranges_on_the_engines_thread(tiny, monkeypatch, tmp_path,
                                                                  recorder):
    """The profiler starts and stops on the engine thread, inside its decode
    programs (a profiler records the thread that started it)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    calls = {"n": 0}
    started = threading.Event()
    program = tengine.decode_program

    def profiled(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            prof.__enter__()
            started.set()
        elif calls["n"] == 30:
            prof.__exit__(None, None, None)
        return program(*a, **k)

    monkeypatch.setattr(tengine, "decode_program", profiled)
    eng = _engine(tiny, False, max_batch=2)
    try:
        first = eng.submit([5, 6, 7, 8], max_new=60)
        assert started.wait(60)
        eng.submit([9, 10, 11], max_new=5).result(timeout=60)
        first.result(timeout=60)
    finally:
        eng.stop(timeout=30)
    ranges = _ranges(_export(prof, tmp_path / "engine.json"))
    count = {n: sum(r[0] == n for r in ranges) for n in ENGINE_RANGES | {"serve.prefill"}}
    # steps 3-30 entered their range in the profile (step 30's, open when
    # the profiler stopped, is kept); a host turn follows steps 2-29 and
    # the admission pass
    assert count == {"serve.admit": 1, "serve.prefill": 1, "serve.decode_step": 28,
                     "serve.emit": 29}
    admit = next(r for r in ranges if r[0] == "serve.admit")
    assert _inside(next(r for r in ranges if r[0] == "serve.prefill"), admit)
    mine = sorted((r for r in ranges if r[0] in ENGINE_RANGES), key=lambda r: r[1])
    assert all(a[2] <= b[1] for a, b in zip(mine, mine[1:]))  # one after another
    assert not ENGINE_RANGES & {s.name for s in recorder.spans()}


# ------------------------------------------------------------ training ----


def test_the_training_steps_layers_nest_on_the_profilers_trace(recorder, tmp_path):
    cfg = ttrainer.TrainConfig(model="llama-tiny-moe", batch_size=2, seq_len=16, lr=1e-3,
                               warmup_steps=1, total_steps=4, log_every=2, seed=3)
    tr = ttrainer.Trainer(cfg, device="cpu")
    tr.init()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(steps=2)
    ranges = _ranges(_export(prof, tmp_path / "train.json"))
    names = [r[0] for r in ranges]
    for name in ("train.step", "train.forward_backward", "train.grad_norm",
                 "train.optimizer"):
        assert names.count(name) == 2, name
    assert names.count("train.feed") == 2  # the first batch, then the second in step 1
    assert names.count("moe.forward") == 2 * cfg.model_config().n_layers
    steps = [r for r in ranges if r[0] == "train.step"]
    fwd = [r for r in ranges if r[0] == "train.forward_backward"]
    for r in ranges:
        if r[0] in ("train.forward_backward", "train.grad_norm", "train.optimizer"):
            assert any(_inside(r, s) for s in steps), r
        if r[0] == "moe.forward":
            assert any(_inside(r, f) for f in fwd), r
    assert [s.name for s in recorder.spans()] == ["train.step", "train.step"]
