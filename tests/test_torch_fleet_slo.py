"""The port's fleet SLO plane (``oim_tpu_torch/obs``, ``cli/oim_monitor.py``)
held against ``oim_tpu``'s on the CPU.

* Each file equals JAX's source once ``oim_tpu.`` reads
  ``oim_tpu_torch.``, but for the lines listed below by content, each with
  its reason.
* ``merge``: a seeded sweep of snapshots gives JAX's quantiles, good
  counts, bucket indices, resets, sums and majority-grid merges; seeded
  ``FleetHistogram`` and ``FleetCounter`` histories (counter resets, grid
  changes, departures) give JAX's fleet views at every step.
* ``slo``: seeded scripts of ingests, forgets and explicit clocks give
  JAX's transitions, burn rates and status bodies; the port's engine
  emits ``slo_alert_*`` into the port's ring and sets the port's gauges,
  none of JAX's.
* ``FleetMonitor`` over the port's registry publishes and deletes the
  ``alert/<name>`` rows JAX's publishes over JAX's for the same feed.
* ``autopsy`` collects and analyzes a trace as JAX's does.
* ``oim-monitor``'s parser equals JAX's.
* A fresh interpreter loads the SLO engine, the reconcile core and
  ``metrics_snapshot`` without grpc or protobuf (the card machine has
  neither).
"""

from __future__ import annotations

import argparse
import difflib
import json
import math
import random
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

from oim_tpu.cli import oim_monitor as joim_monitor
from oim_tpu.common import events as jevents
from oim_tpu.common import metrics as jmetrics
from oim_tpu.common.channelpool import ChannelPool as JChannelPool
from oim_tpu.obs import autopsy as jautopsy
from oim_tpu.obs import merge as jmerge
from oim_tpu.obs import monitor as jmonitor
from oim_tpu.obs import slo as jslo
from oim_tpu.registry import MemRegistryDB as JMemRegistryDB
from oim_tpu.registry import RegistryService as JRegistryService
from oim_tpu.registry.registry import registry_server as jregistry_server
from oim_tpu.spec import RegistryStub as JRegistryStub
from oim_tpu.spec import pb as jpb
from oim_tpu_torch.cli import oim_monitor
from oim_tpu_torch.common import events
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.channelpool import ChannelPool
from oim_tpu_torch.obs import autopsy, merge, monitor, slo
from oim_tpu_torch.registry import MemRegistryDB, RegistryService
from oim_tpu_torch.registry.registry import registry_server
from oim_tpu_torch.spec import oim_pb2 as pb
from oim_tpu_torch.spec.services import RegistryStub

_ROOT = Path(__file__).resolve().parent.parent

_SPEC = ("the port's spec package holds the params dataclasses; the wire is "
         "spec.oim_pb2 and spec.services, so the spec package loads without grpcio")

# file -> [(JAX's line after the prefix rewrite, or None; the port's line,
#           or None; why)]
LISTED: dict[str, list[tuple[str | None, str | None, str]]] = {
    "obs/__init__.py": [],
    "obs/merge.py": [],
    "obs/slo.py": [],
    "obs/autopsy.py": [],
    "obs/monitor.py": [
        ("from oim_tpu_torch.spec import RegistryStub, pb",
         "from oim_tpu_torch.spec import oim_pb2 as pb", _SPEC),
        (None, "from oim_tpu_torch.spec.services import RegistryStub", _SPEC),
    ],
    "cli/oim_monitor.py": [],
}


def _same_as_jax(rel: str, listed: list) -> None:
    jax_lines = (_ROOT / "oim_tpu" / rel).read_text().replace(
        "oim_tpu.", "oim_tpu_torch.").splitlines()
    port_lines = (_ROOT / "oim_tpu_torch" / rel).read_text().splitlines()
    removed, added = Counter(), Counter()
    ops = difflib.SequenceMatcher(None, jax_lines, port_lines, autojunk=False).get_opcodes()
    for tag, i1, i2, j1, j2 in ops:
        if tag != "equal":
            removed.update(jax_lines[i1:i2])
            added.update(port_lines[j1:j2])
    assert removed == Counter(j for j, _, _ in listed if j is not None)
    assert added == Counter(p for _, p, _ in listed if p is not None)
    assert all(why for _, _, why in listed)


def test_every_file_of_obs_is_listed():
    jax_files = {p.name for p in (_ROOT / "oim_tpu" / "obs").glob("*.py")}
    port_files = {p.name for p in (_ROOT / "oim_tpu_torch" / "obs").glob("*.py")}
    assert jax_files == port_files == {k.split("/")[1] for k in LISTED if k.startswith("obs/")}


@pytest.mark.parametrize("rel", sorted(LISTED))
def test_copy_equals_jax_source_but_the_listed_lines(rel):
    _same_as_jax(rel, LISTED[rel])


def _canon(x) -> str:
    """JSON with NaN spelled out, tuples as lists: exact equality of two
    packages' results, NaN included."""
    return json.dumps(x, sort_keys=True, default=repr)


# ------------------------------------------------------------------ merge --


GRIDS = (list(jmetrics.DEFAULT_BUCKETS), [0.001, 0.01, 0.1, 1.0])


def _snap(rng: random.Random, le: list, scale: int = 20) -> dict:
    counts, c = [], 0
    for _ in range(len(le) + 1):
        c += rng.randrange(scale)
        counts.append(c)
    return {"le": list(le), "counts": counts, "sum": round(rng.uniform(0, 50), 6)}


BAD_SNAPS = [None, "x", {"le": [1.0], "counts": [1], "sum": 0.0},
             {"le": [1.0, 0.5], "counts": [0, 1, 2], "sum": 1.0},
             {"le": [0.5, 1.0], "counts": [2, 1, 3], "sum": 1.0},
             {"le": [0.5, 1.0], "counts": [0, 1, 2], "sum": -1.0},
             {"le": [0.5, 1.0], "counts": [0, 1, True], "sum": 1.0}]


def _validated(mod, snap):
    try:
        return mod.validate(snap)
    except ValueError as err:
        return f"ValueError: {err}"


@pytest.mark.parametrize("seed", range(6))
def test_snapshot_algebra_equals_jax(seed):
    rng = random.Random(seed)
    snaps = [_snap(rng, GRIDS[rng.randrange(2)], scale=rng.choice((1, 5, 50)))
             for _ in range(12)]
    snaps.append(merge.zero(GRIDS[0]))
    qs = (0.0, 0.01, 0.5, 0.9, 0.99, 1.0)
    for mod in (merge, jmerge):
        got = []
        for s in snaps:
            thresholds = s["le"] + [b * 1.5 for b in s["le"]] + [0.0, 1e9]
            got.append([mod.total(s), [mod.quantile(s, q) for q in qs],
                        [mod.good_count(s, t) for t in thresholds],
                        [mod.bucket_index(s, v) for v in thresholds]])
        got.append([mod.is_reset(a, b) for a in snaps for b in snaps])
        got.append([mod.add(a, b) for a in snaps for b in snaps if a["le"] == b["le"]])
        got.append(mod.merge_snapshots(snaps + BAD_SNAPS))
        got.append([_validated(mod, s) for s in BAD_SNAPS + snaps])
        if mod is merge:
            port = _canon(got)
    assert port == _canon(got)


def _fleet_script(rng: random.Random, n: int = 60) -> list[tuple]:
    """Updates with counter resets (a replica restarted), grid changes,
    malformed snapshots and departures across 4 replicas."""
    last: dict = {}
    script = []
    for _ in range(n):
        rid = f"r{rng.randrange(4)}"
        roll = rng.random()
        if roll < 0.1:
            script.append(("forget", rid))
            last.pop(rid, None)
            continue
        prev = last.get(rid)
        if prev is not None and 0.2 <= roll < 0.25:   # malformed: refused
            script.append(("update", rid, BAD_SNAPS[rng.randrange(2, len(BAD_SNAPS))]))
            continue
        if prev is None or roll < 0.2:       # a fresh epoch: counts from zero
            snap = _snap(rng, GRIDS[0] if roll > 0.15 else GRIDS[1], scale=4)
        else:                               # grows on the same grid
            snap = jmerge.add(prev, _snap(rng, prev["le"], scale=6))
        last[rid] = snap
        script.append(("update", rid, snap))
    return script


def _run_fleet(mod, script) -> list:
    fleet, trail = mod.FleetHistogram(), []
    for op, rid, *rest in script:
        if op == "forget":
            fleet.forget(rid)
        else:
            try:
                fleet.update(rid, rest[0])
            except ValueError as err:
                trail.append(f"ValueError: {err}")
        trail.append([fleet.merged(), fleet.merged_scratch(), fleet.replicas(),
                      [fleet.replica(f"r{i}") for i in range(4)]])
    return trail


def _run_counter(mod, rng: random.Random) -> list:
    fleet, trail, last = mod.FleetCounter(), [], {}
    for _ in range(60):
        rid = f"r{rng.randrange(3)}"
        roll = rng.random()
        if roll < 0.1:
            fleet.forget(rid)
            last.pop(rid, None)
        else:
            base = {} if roll < 0.2 else dict(last.get(rid, {}))
            for outcome in ("length", "eos", "rejected", "error"):
                base[outcome] = base.get(outcome, 0.0) + rng.randrange(5)
            if roll > 0.95:
                base["junk"] = float("nan")
            last[rid] = base
            fleet.update(rid, base)
        trail.append(fleet.merged())
    return trail


@pytest.mark.parametrize("seed", range(6))
def test_fleet_histogram_and_counter_equal_jax(seed):
    script = _fleet_script(random.Random(seed))
    port, ref = _run_fleet(merge, script), _run_fleet(jmerge, script)
    assert _canon(port) == _canon(ref)
    assert any(isinstance(t, str) for t in port)  # a malformed snapshot was refused
    assert _canon(_run_counter(merge, random.Random(seed))) == \
        _canon(_run_counter(jmerge, random.Random(seed)))


# -------------------------------------------------------------------- slo --


def _latency_snapshot(rng: random.Random, prev: dict | None, bad_share: float) -> dict:
    """One replica's cumulative first-token snapshot after a few more
    requests, ``bad_share`` of them slower than 0.1 s."""
    le = list(jmetrics.DEFAULT_BUCKETS)
    counts = list(prev["counts"]) if prev else [0] * (len(le) + 1)
    total = prev["sum"] if prev else 0.0
    for _ in range(rng.randrange(1, 8)):
        v = rng.uniform(0.2, 3.0) if rng.random() < bad_share else rng.uniform(0.001, 0.09)
        total += v
        for i, bound in enumerate(le + [math.inf]):
            if v <= bound:
                counts[i] += 1
    return {"le": le, "counts": counts, "sum": total}


def _slo_script(seed: int) -> list[tuple]:
    """Ingests, forgets and evaluations at explicit clocks: a healthy
    stretch, an incident, and a recovery, with a restart and a departure
    along the way."""
    rng = random.Random(seed)
    rows: dict = {}
    script, now = [], 1000.0
    for step in range(70):
        now += rng.uniform(0.5, 3.0)
        bad = 0.6 if 20 <= step < 40 else 0.0
        for rid in ("r0", "r1", "r2"):
            if rng.random() < 0.05:                 # restarted: counts from zero
                rows.pop(rid, None)
            prev = rows.get(rid)
            hist = _latency_snapshot(rng, prev["hist"]["first_token"] if prev else None, bad)
            counters = dict(prev["counters"]["requests_total"]) if prev else {}
            for outcome in ("length", "rejected", "error"):
                if outcome == "length" or rng.random() < bad / 2:
                    counters[outcome] = counters.get(outcome, 0) + rng.randrange(1, 4)
            rows[rid] = {"hist": {"first_token": hist, "rpc": hist},
                         "counters": {"requests_total": counters}}
            script.append(("ingest", rid, json.loads(json.dumps(rows[rid]))))
        if step == 50:
            script.append(("forget", "r2", None))
            rows.pop("r2")
        if step % 9 == 4:
            script.append(("ingest", "r9", "not a row"))
        script.append(("evaluate", None, now))
    return script


def _slos(mod, name: str):
    return [mod.SLO(name=f"{name}_ft", kind="latency", objective=0.99,
                    metric="first_token", threshold_s=0.1),
            mod.SLO(name=f"{name}_av", kind="availability", objective=0.99)]


def _run_slo(mod, script, name: str) -> list:
    eng = mod.SloEngine(_slos(mod, name), fast_window_s=8.0, slow_window_s=40.0,
                        burn_threshold=10.0, resolve_hold_s=6.0)
    trail = []
    for op, rid, arg in script:
        if op == "ingest":
            eng.ingest(rid, arg)
        elif op == "forget":
            eng.forget(rid)
        else:
            trail.append([eng.evaluate(now=arg), [eng.status(s.name) for s in eng.slos],
                          eng.firing(), eng.fleet_quantiles("first_token"),
                          eng.fleet_quantiles("queue_wait")])
    return trail


def _ring_counts(rec) -> dict:
    counts = rec.counts()
    return {t: counts.get(t, 0) for t in ("slo_alert_fired", "slo_alert_resolved")}


@pytest.mark.parametrize("seed", range(4))
def test_slo_engine_gives_jax_transitions_and_lands_in_the_ports_ring(seed):
    name = f"sweep{seed}"
    script = _slo_script(seed)
    jbefore = _ring_counts(jevents.recorder())
    before = _ring_counts(events.recorder())
    port = _run_slo(slo, script, name)
    # The port's engine wrote the port's ring and gauges, and none of JAX's.
    assert _ring_counts(jevents.recorder()) == jbefore
    assert f'slo="{name}_ft"' not in jmetrics.DEFAULT.render()
    assert math.isclose(M.SLO_BURN_RATE.labels(slo=f"{name}_ft").value,
                        port[-1][1][0]["burn_fast"], abs_tol=1e-4)
    ref = _run_slo(jslo, script, name)
    assert _canon(port) == _canon(ref)
    moved = [t["transition"] for step in port for t in step[0]]
    assert "fired" in moved and "resolved" in moved, moved
    after = _ring_counts(events.recorder())
    assert after["slo_alert_fired"] - before["slo_alert_fired"] == moved.count("fired")
    assert after["slo_alert_resolved"] - before["slo_alert_resolved"] == \
        moved.count("resolved")
    assert M.SLO_ALERTS_FIRING.value == len(port[-1][2])


def test_slo_declarations_refuse_as_jax():
    cases = [dict(name="a", kind="nope", objective=0.9),
             dict(name="a", kind="latency", objective=1.0),
             dict(name="a", kind="latency", objective=0.9),
             dict(name="a", kind="latency", objective=0.9, metric="first_token")]
    for kw in cases:
        with pytest.raises(ValueError) as port:
            slo.SLO(**kw)
        with pytest.raises(ValueError) as ref:
            jslo.SLO(**kw)
        assert str(port.value) == str(ref.value)
    for mod in (slo, jslo):
        with pytest.raises(ValueError, match="duplicate"):
            mod.SloEngine(_slos(mod, "d") * 2)
        with pytest.raises(ValueError, match="shorter"):
            mod.SloEngine(fast_window_s=10, slow_window_s=10)
    assert _canon([vars(s) for s in slo.default_slos(0.3, 0.99)]) == \
        _canon([vars(s) for s in jslo.default_slos(0.3, 0.99)])
    assert (slo.HIST_KEYS, slo.DEFAULT_BURN_THRESHOLD) == \
        (jslo.HIST_KEYS, jslo.DEFAULT_BURN_THRESHOLD)


# ---------------------------------------------------------------- monitor --


class _Plane:
    def __init__(self, pkg: str):
        port = pkg == "port"
        db, svc, serve = ((MemRegistryDB, RegistryService, registry_server) if port else
                          (JMemRegistryDB, JRegistryService, jregistry_server))
        self.server = serve("tcp://localhost:0", svc(db=db()))
        self.addr = self.server.addr
        self.pool = ChannelPool() if port else JChannelPool()
        self.stub = (RegistryStub if port else JRegistryStub)(self.pool.get(self.addr, None))
        self.pb = pb if port else jpb

    def put(self, path: str, body) -> None:
        self.stub.SetValue(self.pb.SetValueRequest(value=self.pb.Value(
            path=path, value=json.dumps(body), lease_seconds=60.0)), timeout=5.0)

    def rows(self, prefix: str) -> dict:
        reply = self.stub.GetValues(self.pb.GetValuesRequest(path=prefix), timeout=5.0)
        return {v.path: json.loads(v.value) for v in reply.values}

    def close(self) -> None:
        self.server.force_stop()
        self.pool.close()


def _drive_monitor(pkg: str, script) -> list:
    mod = monitor if pkg == "port" else jmonitor
    smod = slo if pkg == "port" else jslo
    plane = _Plane(pkg)
    mon = mod.FleetMonitor(
        plane.addr,
        smod.SloEngine(_slos(smod, "mon"), fast_window_s=8.0, slow_window_s=40.0,
                       burn_threshold=10.0, resolve_hold_s=6.0),
        interval=30.0, pool=plane.pool, watch=False, monitor_id="mon-test")
    trail = []
    try:
        for op, rid, arg in script:
            if op == "ingest" and isinstance(arg, dict):
                plane.put(f"telemetry/{rid}", arg)
            elif op == "evaluate":
                moved = mon.tick_once(now=arg)
                trail.append([moved, plane.rows("alert")])
    finally:
        mon.stop(deregister=True)
        trail.append(plane.rows("alert"))
        plane.close()
    return trail


def test_monitor_publishes_the_alert_rows_jax_publishes():
    """The same telemetry rows, polled at the same clocks, give the same
    transitions and the same ``alert/<name>`` rows (the forget of the
    script stays out: GetValues polling sees rows, not deletes)."""
    script = [s for s in _slo_script(1) if s[0] != "forget"][:900]
    port, ref = _drive_monitor("port", script), _drive_monitor("jax", script)
    assert _canon(port) == _canon(ref)
    fired = [rows for _, rows in port[:-1] if rows]
    assert fired and all(set(r) <= {"alert/mon_ft", "alert/mon_av"} for r in fired)
    assert all(b["monitor"] == "mon-test" and b["state"] == "firing"
               for r in fired for b in r.values())
    assert port[-1] == {}  # a clean stop deletes the rows it owns


def test_alert_key_refuses_as_jax():
    assert monitor.alert_key("x") == jmonitor.alert_key("x") == "alert/x"
    for bad in ("", "a/b"):
        with pytest.raises(ValueError):
            monitor.alert_key(bad)


# ---------------------------------------------------------------- autopsy --


def _span(name, ts_ms, dur_ms, trace="t1", sid="", **attrs):
    return {"ph": "X", "name": name, "ts": ts_ms * 1e3, "dur": dur_ms * 1e3,
            "args": {"trace_id": trace, "span_id": sid or name, **attrs}}


DOCS = {
    "10.0.0.1:9": {
        "spans": {"traceEvents": [
            _span("router.generate", 0, 120),
            _span("client:oim.v1.Serve/Generate", 1, 10, sid="hop1", code="UNAVAILABLE",
                  parent_id="router.generate"),
            _span("client:oim.v1.Serve/Generate", 12, 105, sid="hop2", code="OK",
                  parent_id="router.generate"),
            _span("router.generate", 0, 50, trace="other")]},
        "events": {"events": [{"seq": 1, "ts": 0.011, "type": "router_retry",
                               "trace_id": "t1", "attrs": {"replica": "r1"}}]}},
    "10.0.0.2:9": {
        "spans": {"traceEvents": [
            _span("server:oim.v1.Serve/Generate", 13, 103),
            _span("serve.generate", 13, 102),
            _span("serve.queue_wait", 14, 20),
            _span("serve.prefill", 35, 30, tokens=20),
            _span("serve.decode", 66, 40, tokens=9)]},
        "events": {"events": [{"seq": 4, "ts": 0.05, "type": "slot_evicted",
                               "trace_id": "t1", "attrs": {}}]}},
}


def _http_get(url: str) -> str:
    host = url.split("/")[2]
    if host not in DOCS:
        raise OSError(f"no route to {host}")
    return json.dumps(DOCS[host]["spans" if url.endswith("/debug/spans") else "events"])


def test_autopsy_equals_jax_on_the_same_daemons():
    targets = list(DOCS) + ["10.0.0.3:9", "10.0.0.1:9"]
    out = []
    for mod in (autopsy, jautopsy):
        collected = mod.collect("t1", targets, http_get=_http_get)
        report = mod.analyze(collected)
        out.append([collected, report, mod.render(report)])
        with pytest.raises(ValueError, match="no router.generate"):
            mod.analyze({"trace_id": "t9", "spans": [], "events": [], "unreachable": []})
    assert _canon(out[0]) == _canon(out[1])
    assert out[0][0]["unreachable"] == ["10.0.0.3:9"]


# -------------------------------------------------------------------- CLI --


class _Parsed(Exception):
    pass


def parser_of(main) -> list:
    """Every flag of the parser ``main`` builds, with its default, arity,
    type, action and choices (the shared flags' help text is the port's
    own, ``cli/common.py``)."""
    real = argparse.ArgumentParser.parse_args
    seen = {}

    def capture(self, *a, **k):
        seen["parser"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    parser = seen["parser"]
    return [parser.prog] + [(a.option_strings, a.dest, repr(a.default), a.nargs,
                             getattr(a.type, "__name__", a.type), type(a).__name__,
                             a.required, a.choices) for a in parser._actions]


def test_monitor_cli_parser_equals_jax():
    assert parser_of(oim_monitor.main) == parser_of(joim_monitor.main)


# ------------------------------------------------------------------ wire ----


def test_decision_core_loads_without_grpc():
    code = ("import sys; import oim_tpu_torch.obs, oim_tpu_torch.obs.slo, "
            "oim_tpu_torch.autoscale.reconcile, oim_tpu_torch.autoscale.launcher; "
            "from oim_tpu_torch.common.snapshot import metrics_snapshot; "
            "from oim_tpu_torch.autoscale import FleetSpec, plan; metrics_snapshot(); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('grpc', 'jax', "
            "'oim_tpu') or m.startswith('google.protobuf')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=_ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_telemetry_reexports_the_grpc_free_snapshot():
    from oim_tpu.common import telemetry as jtelemetry
    from oim_tpu_torch.common import snapshot, telemetry

    assert telemetry.metrics_snapshot is snapshot.metrics_snapshot
    port, ref = snapshot.metrics_snapshot(), jtelemetry.metrics_snapshot()
    assert set(port) <= {"hist", "counters"} and "rpc" in port["hist"]
    assert set(port["hist"]["rpc"]) == set(ref["hist"]["rpc"]) == {"le", "counts", "sum"}
