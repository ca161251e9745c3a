"""The serving driver: a closed loop of clients against the port's
``ServeEngine``, the window's end-to-end metrics, the per-layer readings,
and the comparison with the plain reference that decides ``correct``.

Set-up: weights from the seed, the engine, and one request at each
prefill bucket the mix can send (every shape the window uses: the decode
step's shape is the engine's fixed batch). Then ``clients`` threads
each send the mix's next request, read its token stream, stamp each
token on the host clock as it arrives, and send the next one at once.
The window opens once every client's first request has its first token
(the ramp: a closed loop starts with every client's prefill at once,
which no steady state has) and lasts ``seconds``. At the close no client
sends again; with the mix's ``at_close`` "first_token" a request sent in
the window is waited on until its first token (its time to first token
counts the wait), with "cancel" every request is cancelled at once.
``--trace 1`` profiles a part of the window on the engine thread."""

from __future__ import annotations

import bisect
import contextlib
import gc
import sys
import threading
import time

import numpy as np
import torch

from benchmark.harness import reference, stats, traffic, weights
from benchmark.harness.trace import Profiler, in_range, patched

TRACE_LEAD_S = 2.0  # the profiled part starts this far into the window
TRACE_SPAN_S = 3.0  # and lasts this long (or to the window's close)
FIRST_TOKEN_WAIT_S = 60.0
RAMP_LIMIT_S = 120.0  # the longest the ramp may take before the window opens anyway
RANGES = ("decode_program", "prefill_program")


def say(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


class _Client(threading.Thread):
    def __init__(self, engine, reqs, take, closed, temperature, log):
        super().__init__(daemon=True)
        self.engine, self.reqs, self.take, self.closed = engine, reqs, take, closed
        self.temperature, self.log = temperature, log
        self.answered = threading.Event()  # a first token has come back

    def run(self) -> None:
        while not self.closed.is_set():
            i = self.take()
            prompt = self.reqs.tokens(i)
            _, out_len = self.reqs.lengths(i)
            rec = {"i": i, "prompt": prompt, "max_new": out_len, "tokens": [],
                   "times": [], "sent": time.monotonic(), "reason": "", "handle": None}
            self.log.append(rec)
            try:
                rec["handle"] = handle = self.engine.submit(
                    prompt, max_new=out_len, temperature=self.temperature)
            except Exception as err:  # noqa: BLE001 - a refusal is a failed request
                rec["reason"] = f"refused: {err!r}"
                continue
            try:
                for tok in handle.tokens(timeout=FIRST_TOKEN_WAIT_S):
                    rec["times"].append(time.monotonic())
                    rec["tokens"].append(tok)
                    self.answered.set()
                    if self.closed.is_set():
                        handle.cancel()
                        break
            except Exception as err:  # noqa: BLE001 - queue.Empty: no answer in time
                rec["reason"] = f"no answer: {err!r}"
                handle.cancel()
                continue
            rec["reason"] = handle.finish_reason or "cancelled at the close"


def _buckets(engine, longest: int) -> list[int]:
    out, b = [], engine.MIN_PREFILL_BUCKET
    while True:
        out.append(min(b, engine.max_seq))
        if b >= longest or b >= engine.max_seq:
            return out
        b *= 2


def run(cell: dict, fam, d, mix: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, fault=None, control: bool = False) -> dict:
    """One run of a serving cell of family ``fam`` (its module) at sizes
    ``d``; returns the pieces of the result line and the per-layer
    readers' context. ``fault`` (tests only) breaks the timed path;
    ``control`` adds the fp8 reference's reading."""
    from oim_tpu_torch.common import tracing
    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.serve import engine as eng

    device = torch.device(device)
    dtype = weights.DTYPES[d.dtype]
    cfg = fam.serve_config(d, mix, dtype)
    tracing.configure("benchmark", capacity=1 << 16)
    params = fam.make_params(d, seed, device)
    e_cfg = mix["engine"]
    clients = int(mix["clients"])
    engine = eng.ServeEngine(params, cfg, max_batch=e_cfg["max_batch"],
                             max_seq=e_cfg["max_seq"], queue_depth=max(64, 2 * clients),
                             device=device)
    say(f"weights and engine at {time.monotonic() - t_start:.2f} s")
    reqs = traffic.Requests(mix, seed, d.vocab)
    warm = np.random.default_rng(12345)
    for b in _buckets(engine, reqs.max_prompt()):
        n = min(b, e_cfg["max_seq"] - 2)
        engine.submit(warm.integers(0, d.vocab, n).tolist(), max_new=2).result()
    while engine.active_slots:  # idle, as evict_prefix_store asks
        time.sleep(0.001)
    engine.evict_prefix_store()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    say(f"setup {setup_s:.2f} s")

    # -- the window --------------------------------------------------------
    # The per-layer readings take from the program only its module-level
    # device programs (wrapped in the harness's ranges: their start times
    # give the step period, and the profiler starts and stops inside them,
    # on the engine's own thread), its counters and its spans; the rest
    # comes from the clients' own token stamps.
    prof = Profiler() if trace else None
    calls: list[tuple[str, float]] = []
    profiling = {"want": False, "on": False}

    def note(kind):
        def before(*_a, **_k):
            want = profiling["want"]
            if want != profiling["on"]:
                (prof.start if want else prof.stop)()
                profiling["on"] = want
            calls.append((kind, time.monotonic()))
        return before

    log: list[dict] = []
    counter = iter(range(1 << 62))
    lock = threading.Lock()

    def take():
        with lock:
            return next(counter)

    closed = threading.Event()
    temperature = float(mix.get("temperature", 0.0))
    faults = _fault_patches(gen, fault)
    with patched(eng, "decode_program", in_range("decode_program", note("decode"))), \
            patched(eng, "prefill_program", in_range("prefill_program", note("prefill"))), \
            faults:
        threads = [_Client(engine, reqs, take, closed, temperature, log)
                   for _ in range(clients)]
        t_ramp = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:  # the ramp: every client's first request admitted
            t.answered.wait(RAMP_LIMIT_S)
        t0, w0 = time.monotonic(), time.time()
        before = engine.stats()["target_steps"], engine.request_stats()["decode_row_steps"]
        say(f"ramp {t0 - t_ramp:.2f} s")
        if prof is not None:
            time.sleep(max(0.0, t0 + min(TRACE_LEAD_S, seconds / 4) - time.monotonic()))
            profiling["want"] = True
            while not profiling["on"] and time.monotonic() < t0 + seconds:
                time.sleep(0.01)  # the profiler starts at the engine's next device program
            span = min(TRACE_SPAN_S, seconds / 2, t0 + seconds - time.monotonic())
            time.sleep(max(0.0, span))
            profiling["want"] = False
        time.sleep(max(0.0, t0 + seconds - time.monotonic()))
        t1, w1 = time.monotonic(), time.time()
        closed.set()
        after = engine.stats()["target_steps"], engine.request_stats()["decode_row_steps"]
        if mix.get("at_close", "cancel") == "cancel":
            for r in list(log):
                if r["handle"] is not None:
                    r["handle"].cancel()
        for t in threads:
            t.join(timeout=FIRST_TOKEN_WAIT_S + 30)
        say(f"close {time.monotonic() - t1:.2f} s")
        engine.stop(drain=False)
        if profiling["on"]:  # no device program ran after the span's end
            prof.stop()
            profiling["on"] = False
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not finish after the window closed")
    if engine.error:
        raise RuntimeError(f"the engine died:\n{engine.error}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # -- end-to-end metrics ---------------------------------------------------
    sent = [r for r in log if t0 <= r["sent"] < t1]
    failed = [r for r in sent if r["reason"].startswith(("refused", "no answer", "error"))]
    out_tokens = sum(stats.count_in_window(r["times"], t0, t1) for r in log)
    gaps = [g for r in log for g in stats.gaps_in_window(r["times"], t0, t1)]
    ttfts = [(r["times"][0] - r["sent"]) if r["times"] else stats.MISSING for r in sent]
    window = t1 - t0
    e2e = {"output_tokens_per_s": out_tokens / window,
           "itl_p95_ms": stats.percentile(gaps, 95) * 1e3 if gaps else None,
           "ttft_p95_ms": stats.percentile(ttfts, 95) * 1e3 if ttfts else None,
           "setup_s": setup_s}
    steps = decode_steps(calls)
    traced = None
    if prof is not None and prof.t1 > prof.t0:
        import os
        import tempfile

        path = os.path.join(tempfile.gettempdir(), f"benchmark_trace_{os.getpid()}.json")
        traced = prof.reduce(path, RANGES)
        contexts = [live_contexts(log, a, b) for a, b, _ in steps if prof.t0 <= a < prof.t1]
        traced["decode_bytes"] = sum(fam.decode_step_bytes(d, c) for c in contexts if c)
        traced["decode_steps"] = sum(1 for c in contexts if c)
    spans = [(s.duration, int(s.attrs.get("prompt_tokens", 0)))
             for s in tracing.recorder().spans()
             if s.name == "serve.prefill" and w0 <= s.start_unix < w1]
    untraced = [b - a for a, b, plain in steps if plain and t0 <= a and b < t1
                and (prof is None or b < prof.t0 or a > prof.t1)]
    window_flops = 0.0
    for r in log:
        n = len(r["prompt"])
        for j, t in enumerate(r["times"]):
            if t0 <= t < t1:
                window_flops += (fam.prompt_flops(d, n) if j == 0
                                 else fam.forward_flops(d, n + j))
    context = {
        "kind": "serve", "family": fam, "dims": d, "mix": mix, "window_s": window,
        "counters": {"target_steps": after[0] - before[0],
                     "decode_row_steps": after[1] - before[1],
                     "max_batch": e_cfg["max_batch"]},
        "step_s": untraced, "prefill_spans": spans, "window_flops": window_flops,
        "trace": traced,
    }

    # -- the comparison with the reference ------------------------------------
    del engine, threads
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for r in log:
        r.pop("handle", None)
    t_ref = time.monotonic()
    check = compare(fam, params, d, log, seed, limits, control)
    say(f"reference {time.monotonic() - t_ref:.2f} s")
    return {"e2e": e2e, "context": context, "attempted": len(sent), "failed": len(failed),
            "memory_peak_bytes": peak, "check": check}


def decode_steps(calls) -> list[tuple[float, float, bool]]:
    """(start, the next device program's start, whether that is a decode
    step too) of each decode step the engine's loop ran. Between two
    decode steps with no prefill between lies the step's period on the
    host clock, its token fetch and the loop's turn included."""
    return [(a, b, kb == "decode") for (ka, a), (kb, b) in zip(calls, calls[1:])
            if ka == "decode"]


def live_contexts(log, a: float, b: float) -> list[int]:
    """Each live row's keys in the decode step from ``a`` to ``b`` (the
    next device program's start), from the clients' token stamps. The
    step emits one token a row just before ``b``: a row is live when its
    first token is stamped before the step's middle and a later one
    within half a step of ``b``; its keys are its prompt and the tokens
    stamped before the middle."""
    half = (b - a) / 2
    out = []
    for r in log:
        times = r["times"]
        i = bisect.bisect_right(times, b - half)
        if 0 < i < len(times) and times[i] <= b + half:
            out.append(len(r["prompt"]) + i)
    return out


def _fault_patches(gen, fault):
    """Break the timed path underneath (tests of the comparison only):
    ``"token"`` alters the tokens of every fifth decode step where they
    are sampled."""
    if fault is None:
        return contextlib.nullcontext()
    if fault != "token":
        raise ValueError(f"unknown serving fault {fault!r}")
    calls = {"n": 0}

    def wrap(sample):
        def altered(logits, temps, uniforms):
            out = sample(logits, temps, uniforms)
            calls["n"] += 1
            if logits.shape[0] > 1 and calls["n"] % 5 == 0:
                out = (out + 1) % logits.shape[-1]
            return out
        return altered
    return patched(gen, "sample", wrap)


def pick_sample(log: list[dict], seed: int, check: dict) -> list[dict]:
    """The requests the comparison reads: of those that finished with all
    their tokens, the one with the most, then others drawn from the seed
    until ``min_served_tokens`` are covered (at most ``max_requests``)."""
    done = [r for r in log if r["reason"] == "length" and len(r["tokens"]) == r["max_new"]]
    if not done:
        return []
    done.sort(key=lambda r: r["i"])
    longest = max(done, key=lambda r: (len(r["tokens"]), -r["i"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(traffic._seed_words(seed) + [2]).permutation(len(rest))
    picked, served = [longest], len(longest["tokens"])
    budget = int(check["max_reference_tokens"]) - len(longest["prompt"]) - served
    for j in order:
        if served >= check["min_served_tokens"] or len(picked) >= check["max_requests"]:
            break
        r = rest[int(j)]
        cost = len(r["prompt"]) + len(r["tokens"])
        if cost > budget:
            continue
        picked.append(r)
        served += len(r["tokens"])
        budget -= cost
    return picked


def compare(fam, params, d, log, seed, limits: dict, control: bool) -> dict:
    """The widest gap by which a served token's reference logit (the
    family's ``logits_at``) lies below the reference's best, over the
    sample; with ``control``, the same reading for the token the fp8
    reference puts first at each of those positions."""
    reference.no_tf32()
    sample = pick_sample(log, seed, limits["sample"])
    widest, control_widest, n_tokens = 0.0, 0.0, 0
    for r in sample:
        seq = r["prompt"] + r["tokens"][:-1]
        n = len(r["prompt"])
        rows = list(range(n - 1, len(seq)))
        ref = fam.logits_at(params, d, seq, rows)
        widest = max(widest, float(reference.served_gaps(ref, r["tokens"]).max()))
        n_tokens += len(r["tokens"])
        if control:
            low = fam.logits_at(params, d, seq, rows, quant="fp8")
            control_widest = max(control_widest,
                                 float(reference.served_gaps(ref, low.argmax(dim=-1)).max()))
        del ref
    out = {"max_logit_gap": {"value": widest, "limit": limits["max_logit_gap"]},
           "requests_compared": len(sample), "tokens_compared": n_tokens}
    if control:
        out["control_max_logit_gap"] = control_widest
    out["ok"] = bool(sample) and widest <= limits["max_logit_gap"]
    if control:  # the control held to the cell's own limit: it has to fail it
        out["control_ok"] = bool(sample) and control_widest <= limits["max_logit_gap"]
    return out
