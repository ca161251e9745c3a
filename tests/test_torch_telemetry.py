"""The port's telemetry row (``common/telemetry.py``, ``cli/common.py``'s
``start_telemetry_row``) held against the JAX package's on the CPU, with
JAX's registry in process.

* ``RegistryRowPublisher``: the same beats give the same row values in
  both packages: a changed snapshot publishes, an unchanged one renews by
  a batched ``Heartbeat(keys=...)`` (no journal record, the ``beat`` stamp
  unchanged), every ``republish_every``-th beat publishes again, and a
  registry that lost the row gets it back at once; ``stop`` deletes it.
* ``TelemetryRegistration`` and ``telemetry_snapshot``: equal rows for the
  same role and endpoint; ``metrics_snapshot`` carries the same series
  and counts for the same serving workload.
* The daemons publish their rows with JAX's default ids: the controller
  (``<controller-id>``, renewed by its heartbeat as a batched key), the
  trainer (``<controller-id>.trainer``) and the serving daemon
  (``<serve-id>``); ``oimctl --top`` lists each and scrapes its metrics;
  every row is gone after the daemon stops; ``--telemetry-id none``
  publishes none.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from oim_tpu.cli import oimctl
from oim_tpu.common import telemetry as jtel
from oim_tpu.common import tlsutil as jtlsutil
from oim_tpu.models import llama as jllama
from oim_tpu.registry import MemRegistryDB, RegistryService
from oim_tpu.registry.registry import registry_server
from oim_tpu.serve import ServeEngine as JServeEngine
from oim_tpu.spec import RegistryStub, pb
from oim_tpu_torch.cli import common as tcommon
from oim_tpu_torch.cli import oim_controller as tcontroller_cli
from oim_tpu_torch.cli import oim_serve as tserve_cli
from oim_tpu_torch.cli import oim_trainer as ttrainer_cli
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import metrics as tmetrics
from oim_tpu_torch.common import telemetry as ttel
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.serve import ServeEngine as TServeEngine
from oim_tpu_torch.serve import weights as tweights

torch.set_num_threads(2)


def wait_for(predicate, timeout=30.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


class Registry:
    def __init__(self):
        self.db = MemRegistryDB()
        self.service = RegistryService(db=self.db)
        self.service.watch.keepalive = 0.02
        self.server = registry_server("tcp://localhost:0", self.service)
        self.addr = self.server.addr
        self.channel = jtlsutil.dial(self.addr, None)
        self.stub = RegistryStub(self.channel)

    def rows(self, path, stale=False):
        return {v.path: v.value for v in self.stub.GetValues(
            pb.GetValuesRequest(path=path, include_stale=stale), timeout=10).values}

    def close(self):
        self.channel.close()
        wait_for(lambda: not self.service.watch._streams, 5)
        self.server.stop()


@pytest.fixture
def registry():
    r = Registry()
    yield r
    r.close()


class Fixed:
    """A row whose snapshot the test sets."""

    def __init__(self, mod, key, addr, **kw):
        outer = self

        class Row(mod.RegistryRowPublisher):
            def snapshot(self):
                return dict(outer.body)

        self.body = {"n": 0}
        self.row = Row(key, addr, interval=0.1, **kw)


def test_row_publisher_beats_equal_jax(registry, monkeypatch):
    """The same sequence of snapshots gives the same row values and the
    same SetValue/Heartbeat calls in both packages."""
    calls = {"jax": [], "port": []}
    for name, mod in (("jax", jtel), ("port", ttel)):
        real_set, real_renew = mod.RegistryRowPublisher._set, \
            mod.RegistryRowPublisher._renew_once
        monkeypatch.setattr(mod.RegistryRowPublisher, "_set",
                            lambda self, v, l, _r=real_set, _c=calls[name]: (
                                _c.append("set"), _r(self, v, l))[1])
        monkeypatch.setattr(mod.RegistryRowPublisher, "_renew_once",
                            lambda self, _r=real_renew, _c=calls[name]: (
                                _c.append("renew"), _r(self))[1])
    rows = [Fixed(jtel, "telemetry/j", registry.addr, republish_every=3),
            Fixed(ttel, "telemetry/t", registry.addr, republish_every=3)]
    values = {"jax": [], "port": []}
    for step in range(7):
        for name, r in zip(("jax", "port"), rows):
            r.body["n"] = 1 if step >= 2 else 0
            if step == 5:  # the registry lost the row (a restart, a swept lease)
                registry.db.set(r.row.key, "")
            snap = r.row.beat_once()
            values[name].append((snap, registry.rows("telemetry").get(r.row.key)))
    assert values["port"] == values["jax"]
    assert calls["port"] == calls["jax"]
    assert calls["port"].count("renew") >= 2 and values["port"][-1][0]["beat"] >= 3
    for r in rows:
        r.row.stop(deregister=True)
    assert not registry.rows("telemetry", stale=True)


def test_telemetry_rows_equal_jax(registry):
    regs = [mod.TelemetryRegistration(tid, "serve", "127.0.0.1:9100", registry.addr,
                                      interval=0.1, collect=None)
            for mod, tid in ((jtel, "j"), (ttel, "t"))]
    try:
        for r in regs:
            r.beat_once()
        rows = registry.rows("telemetry")
        assert rows["telemetry/t"] == rows["telemetry/j"]
        assert json.loads(rows["telemetry/t"]) == {"beat": 1, "metrics": "127.0.0.1:9100",
                                                   "pid": os.getpid(), "role": "serve"}
    finally:
        for r in regs:
            r.stop(deregister=True)
    assert ttel.telemetry_key("r0.serve") == jtel.telemetry_key("r0.serve")
    for bad in ("", "a/b"):
        with pytest.raises(ValueError, match="single path component"):
            ttel.telemetry_key(bad)
    assert ttel.telemetry_snapshot("registry", "h:1", 3) == \
        jtel.telemetry_snapshot("registry", "h:1", 3)


def test_metrics_snapshot_equals_jax_for_the_same_workload():
    """Each package's serving metrics after the same 3 requests: the same
    series, the same bucket grid, the same observation counts and request
    outcomes (the latencies themselves are each run's own)."""
    jcfg = jllama.tiny()
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    tp = tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    before = (jtel.metrics_snapshot(), ttel.metrics_snapshot())
    engs = (JServeEngine(jp, jcfg, max_batch=2, max_seq=64),
            TServeEngine(tp, tllama.tiny(), device="cpu", max_batch=2, max_seq=64))
    try:
        for eng in engs:
            for prompt in ([1, 2, 3], [4, 5], [6]):
                eng.submit(prompt, max_new=4).result(timeout=120)
    finally:
        for eng in engs:
            eng.stop(drain=False, timeout=30)
    after = (jtel.metrics_snapshot(), ttel.metrics_snapshot())

    def grown(a, b):
        out = {}
        for key in ("first_token", "inter_token", "queue_wait"):
            sa, sb = a["hist"].get(key), b["hist"][key]
            counts = np.asarray(sb["counts"]) - (np.asarray(sa["counts"]) if sa else 0)
            out[key] = (tuple(sb["le"]), counts[-1])
        req = b.get("counters", {}).get("requests_total", {})
        prev = a.get("counters", {}).get("requests_total", {})
        # A label missing from a snapshot counts as 0 and a zero delta is
        # dropped: an earlier test in this process may have created a
        # label (e.g. "cancelled") in one package only.
        out["requests"] = {k: d for k in set(req) | set(prev)
                           if (d := req.get(k, 0) - prev.get(k, 0))}
        return out

    jgrow, tgrow = grown(before[0], after[0]), grown(before[1], after[1])
    assert tgrow == jgrow
    assert tgrow["first_token"][1] == 3 and tgrow["requests"]["length"] == 3
    assert set(after[1]["hist"]) <= set(after[0]["hist"]) | {"rpc"}
    assert "rpc" in after[1]["hist"]
    assert list(after[1]["hist"]["rpc"]) == list(after[0]["hist"]["rpc"])


class _Obs:
    """A started metrics server for ``start_telemetry_row``."""

    def __init__(self, mod):
        self.server = mod.MetricsServer(port=0).start()
        self.telemetry = None


def test_start_telemetry_row_needs_a_server_a_registry_and_an_id(registry):
    obs = tcommon.Observability(None, None)
    assert tcommon.start_telemetry_row(obs, "x", "serve", registry.addr) is None
    obs = _Obs(tmetrics)
    try:
        for tid, addr in (("none", registry.addr), ("", registry.addr), ("x", "")):
            assert tcommon.start_telemetry_row(obs, tid, "serve", addr) is None
        reg = tcommon.start_telemetry_row(obs, "x", "serve", registry.addr, interval=0.1)
        assert reg is obs.telemetry and reg.key == "telemetry/x"
        assert wait_for(lambda: "telemetry/x" in registry.rows("telemetry"))
        body = json.loads(registry.rows("telemetry")["telemetry/x"])
        assert body["metrics"] == f"{obs.server.host}:{obs.server.port}"
        reg.stop(deregister=True)
        assert not registry.rows("telemetry", stale=True)
    finally:
        obs.server.stop()


def _top(registry, ident):
    """oimctl --top's row for ``ident``: listed ALIVE, its metrics
    scraped."""
    rows = {r[0]: r for r in oimctl.telemetry_rows(registry.stub)}
    assert ident in rows, sorted(rows)
    row_id, status, role, target, snap = rows[ident]
    assert status == "ALIVE"
    row = oimctl.top_row(row_id, status, role, target, snap)
    assert ident in oimctl.render_top([row])
    return role, row


def test_controller_daemon_publishes_its_row(registry, monkeypatch):
    made = {}
    real = tcontroller_cli.build

    def build(args):
        made["controller"], made["server"] = out = real(args)
        return out

    monkeypatch.setattr(tcontroller_cli, "build", build)
    rc = {}
    thread = threading.Thread(target=lambda: rc.update(rc=tcontroller_cli.main([
        "--controller-id", "host-9", "--endpoint", "tcp://127.0.0.1:0",
        "--controller-address", "127.0.0.1:1", "--registry", registry.addr,
        "--registry-delay", "0.1", "--backend", "malloc", "--metrics-port", "0",
        "--log-level", "error"])), daemon=True)
    thread.start()
    try:
        assert wait_for(lambda: "telemetry/host-9" in registry.rows("telemetry"))
        assert made["controller"].extra_lease_keys == ["telemetry/host-9"]
        role, row = _top(registry, "host-9")
        assert role == "controller"
    finally:
        assert wait_for(lambda: "server" in made)
        made["controller"].stop()
        made["server"].stop()
        thread.join(30)
    tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    assert rc == {"rc": 0}
    assert "telemetry/host-9" not in registry.rows("telemetry", stale=True)


def test_controller_row_off_with_none(registry, monkeypatch):
    args = tcontroller_cli.parse_args([
        "--controller-id", "host-8", "--endpoint", "tcp://127.0.0.1:0",
        "--controller-address", "127.0.0.1:1", "--backend", "malloc",
        "--telemetry-id", "none"])
    controller, server = tcontroller_cli.build(args)
    try:
        assert controller.extra_lease_keys == []
    finally:
        controller.stop()
        server.stop()


def test_trainer_publishes_its_row_while_it_trains(registry, tmp_path, monkeypatch):
    """--registry with --metrics-port: the row telemetry/<controller-id>.
    trainer is up while the trainer trains on a volume published through
    the registry, and gone after."""
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(0).integers(0, 256, 4 * 2 * 17, dtype=np.int32))
    c = tcontroller.Controller(controller_id="host-0",
                               backend=tcontroller_cli.MallocBackend(),
                               controller_address="pending", registry_address=registry.addr,
                               registry_delay=0.1)
    server = tcontroller.controller_server("tcp://localhost:0", c.service)
    c.controller_address = server.addr
    c.start()
    seen = []
    real_step = ttrainer_cli.Trainer.run

    def run(self, *a, **k):
        # The row's first beat is its publisher thread's.
        wait_for(lambda: "telemetry/host-0.trainer" in registry.rows("telemetry"), 30)
        seen.append(registry.rows("telemetry"))
        return real_step(self, *a, **k)

    monkeypatch.setattr(ttrainer_cli.Trainer, "run", run)
    try:
        assert ttrainer_cli.main([
            "--model", "llama-tiny", "--steps", "1", "--batch-size", "2", "--seq-len", "16",
            "--device", "cpu", "--log-level", "error", "--registry", registry.addr,
            "--controller-id", "host-0", "--volume-file", str(path),
            "--feed-window-bytes", "0", "--prefetch-batches", "0",
            "--metrics-port", "0"]) == 0
    finally:
        c.stop()
        server.stop()
        tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    (rows,) = seen
    body = json.loads(rows["telemetry/host-0.trainer"])
    assert body["role"] == "trainer" and body["pid"] == os.getpid()
    assert "telemetry/host-0.trainer" not in registry.rows("telemetry", stale=True)


def test_serving_daemon_publishes_its_row(registry, tmp_path):
    tp = tllama.init(torch.Generator().manual_seed(0), tllama.tiny(), device="cpu")
    packed = str(tmp_path / "w.oimw")
    tweights.save_packed(tp, packed)
    sock = str(tmp_path / "s.sock")
    prev = signal.getsignal(signal.SIGTERM)
    seen, done = {}, threading.Event()

    def client():
        try:
            wait_for(lambda: done.is_set() or "telemetry/r5" in registry.rows("telemetry"), 60)
            seen["top"] = _top(registry, "r5")
        finally:
            # Only to this daemon's own handler, never the test process's.
            installed = wait_for(lambda: done.is_set()
                                 or signal.getsignal(signal.SIGTERM) is not prev, 30)
            if installed and not done.is_set():
                os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    try:
        assert tserve_cli.main([
            "--weights-file", packed, "--backend", "malloc", "--device", "cpu",
            "--endpoint", f"unix://{sock}", "--registry", registry.addr,
            "--serve-id", "r5", "--advertise", "127.0.0.1:2", "--heartbeat", "0.2",
            "--metrics-port", "0", "--log-level", "error",
            "--max-batch", "2", "--max-seq", "64"]) == 0
    finally:
        done.set()
        signal.signal(signal.SIGTERM, prev)
        tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    thread.join(30)
    role, row = seen["top"]
    assert role == "serve"
    assert not registry.rows("telemetry", stale=True)
    assert not registry.rows("serve", stale=True)
