"""The port's fleet actuator (``oim_tpu_torch/autoscale``,
``cli/oim_autoscaler.py``) and its fleet daemons (``cli/oim_registry.py``,
``cli/oim_router.py``) held against ``oim_tpu``'s on the CPU.

* Each file equals JAX's source once ``oim_tpu.`` reads
  ``oim_tpu_torch.``, but for the lines listed below by content, each with
  its reason. The rewrite alone turns the launcher's
  ``python -m oim_tpu.cli.oim_serve`` into the port's daemon.
* ``plan()`` gives JAX's actions and states over a ``hypothesis`` sweep of
  specs, fleets, alert rows, clocks and carried states, one step and
  chained; ``LeaderGate`` gives JAX's answers over swept row histories.
* The counterpart of tests/test_autoscale.py's ``TestAutoscalerDaemon``
  runs over the port's registry with a fake launcher; the port's
  ``Autoscaler`` emits ``autoscale_*`` into the port's ring and sets the
  port's gauges, none of JAX's.
* Across the packages: an alert row that JAX's ``FleetMonitor`` raises
  scales a port ``Autoscaler``'s fleet, and one the port's monitor raises
  scales JAX's.
* The port's ``SubprocessLauncher`` forks the port's ``oim-serve --device
  cpu`` (llama-tiny): it registers ``serve/<id>`` in a port registry, and
  ``drain`` deregisters it and exits 0.
* The parsers of ``oim-autoscaler``, ``oim-registry`` and ``oim-router``
  equal JAX's.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from oim_tpu.autoscale import daemon as jdaemon
from oim_tpu.autoscale import reconcile as jreconcile
from oim_tpu.cli import oim_autoscaler as joim_autoscaler
from oim_tpu.cli import oim_registry as joim_registry
from oim_tpu.cli import oim_router as joim_router
from oim_tpu.common import events as jevents
from oim_tpu.common import metrics as jmetrics
from oim_tpu.obs import monitor as jmonitor
from oim_tpu.obs import slo as jslo
from oim_tpu_torch.autoscale import daemon, reconcile
from oim_tpu_torch.autoscale.launcher import ReplicaLauncher, SubprocessLauncher
from oim_tpu_torch.cli import oim_autoscaler, oim_registry, oim_router
from oim_tpu_torch.common import events
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.obs import monitor, slo
from tests.test_torch_fleet_slo import _Plane, _same_as_jax, parser_of

_ROOT = Path(__file__).resolve().parent.parent

_SPEC = ("the port's spec package holds the params dataclasses; the wire is "
         "spec.oim_pb2 and spec.services, so the spec package loads without grpcio")
_LAZY = ("daemon.py imports grpc at its top and the card machine has no grpcio: "
         "Autoscaler and fleet_key load on first use, so reconcile and launcher "
         "import there")
_LAZY_LINES = [
    "", "", "", "def __getattr__(name):",
    "    # daemon.py imports grpc at its top: Autoscaler and fleet_key load on",
    "    # first use, so reconcile and launcher import without grpcio.",
    '    if name in ("Autoscaler", "fleet_key"):',
    "        from oim_tpu_torch.autoscale import daemon",
    "        return getattr(daemon, name)",
    '    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")']

# file -> [(JAX's line after the prefix rewrite, or None; the port's line,
#           or None; why)]
LISTED: dict[str, list[tuple[str | None, str | None, str]]] = {
    "autoscale/__init__.py": [
        ("from oim_tpu_torch.autoscale.daemon import Autoscaler, fleet_key  # noqa: F401",
         None, _LAZY)] + [(None, line, _LAZY) for line in _LAZY_LINES],
    "autoscale/reconcile.py": [],
    "autoscale/launcher.py": [],
    "autoscale/daemon.py": [
        ("from oim_tpu_torch.spec import RegistryStub, pb",
         "from oim_tpu_torch.spec import oim_pb2 as pb", _SPEC),
        (None, "from oim_tpu_torch.spec.services import RegistryStub", _SPEC),
    ],
    "cli/oim_autoscaler.py": [
        ("           --platform cpu", "           --device cpu",
         "the port's oim-serve takes --device for JAX's --platform"),
    ],
    "cli/oim_registry.py": [],
    "cli/oim_router.py": [],
}


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


def test_every_file_of_autoscale_is_listed():
    jax_files = {p.name for p in (_ROOT / "oim_tpu" / "autoscale").glob("*.py")}
    port_files = {p.name for p in (_ROOT / "oim_tpu_torch" / "autoscale").glob("*.py")}
    assert jax_files == port_files == {k.split("/")[1] for k in LISTED
                                       if k.startswith("autoscale/")}


@pytest.mark.parametrize("rel", sorted(LISTED))
def test_copy_equals_jax_source_but_the_listed_lines(rel):
    _same_as_jax(rel, LISTED[rel])


def test_launcher_forks_the_ports_daemon():
    src = (_ROOT / "oim_tpu_torch" / "autoscale" / "launcher.py").read_text()
    assert '[self.python, "-m", "oim_tpu_torch.cli.oim_serve",' in src
    assert "oim_tpu.cli" not in src


def test_the_package_exports_the_daemon_lazily():
    import oim_tpu.autoscale as jpkg
    import oim_tpu_torch.autoscale as pkg

    assert pkg.Autoscaler is daemon.Autoscaler and pkg.fleet_key is daemon.fleet_key
    assert pkg.__all__ == jpkg.__all__
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        pkg.nope  # noqa: B018


# ------------------------------------------------------------------- plan --


NAMES = ("first_token_p99", "availability")
BODIES = st.one_of(st.just({"state": "firing", "direction": "up"}),
                   st.just({"state": "firing", "direction": "down"}),
                   st.just({"state": "firing"}), st.just({}), st.just("garbage"),
                   st.just({"direction": 5}))
VERSIONS = st.sampled_from(("", "v1", "v2"))
CLOCK = st.floats(min_value=0.0, max_value=200.0, allow_nan=False)


@st.composite
def specs(draw):
    lo = draw(st.integers(0, 3))
    return dict(min_replicas=lo, max_replicas=draw(st.integers(lo, lo + 3)),
                version=draw(VERSIONS), cooldown_s=draw(st.sampled_from((0.0, 5.0, 15.0))),
                scale_down_hold_s=draw(st.sampled_from((0.0, 10.0, 60.0))))


@st.composite
def fleets(draw):
    n = draw(st.integers(0, 5))
    ids = draw(st.lists(st.sampled_from([f"r{i}" for i in range(8)]), min_size=n, max_size=n,
                        unique=True))
    return [dict(replica_id=rid, ready=draw(st.booleans()), version=draw(VERSIONS),
                 score=draw(st.integers(-2, 5))) for rid in ids]


@st.composite
def states(draw):
    return dict(target=draw(st.integers(-1, 6)),
                last_action_at=draw(st.one_of(st.just(float("-inf")), CLOCK)),
                clear_since=draw(st.one_of(st.none(), CLOCK)))


ALERTS = st.dictionaries(st.sampled_from(NAMES), BODIES, max_size=2)


def _plan(mod, spec, observed, alerts, now, state):
    actions, nxt = mod.plan(mod.FleetSpec(**spec),
                            [mod.ObservedReplica(**o) for o in observed], alerts, now,
                            mod.ReconcileState(**state))
    return [dataclasses.astuple(a) for a in actions], dataclasses.astuple(nxt)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(specs(), fleets(), ALERTS, CLOCK, states())
def test_plan_equals_jax(spec, observed, alerts, now, state):
    assert _plan(reconcile, spec, observed, alerts, now, state) == \
        _plan(jreconcile, spec, observed, alerts, now, state)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(specs(), st.lists(st.tuples(fleets(), ALERTS, st.floats(0.0, 30.0)), min_size=1,
                         max_size=8))
def test_chained_plans_equal_jax(spec, steps):
    """A reconcile loop: each step's state is the last step's."""
    out = {}
    for mod in (reconcile, jreconcile):
        state, now, trail = mod.ReconcileState(), 0.0, []
        for observed, alerts, dt in steps:
            now += dt
            actions, state = mod.plan(mod.FleetSpec(**spec),
                                      [mod.ObservedReplica(**o) for o in observed],
                                      alerts, now, state)
            trail.append(([dataclasses.astuple(a) for a in actions],
                          dataclasses.astuple(state)))
        out[mod] = trail
    assert out[reconcile] == out[jreconcile]


@settings(deadline=None)
@given(BODIES)
def test_wants_scale_up_equals_jax(body):
    assert reconcile.wants_scale_up(body) == jreconcile.wants_scale_up(body)


ROWS = st.one_of(st.none(), st.just("garbage"),
                 st.fixed_dictionaries({"autoscaler": st.sampled_from(("me", "as-a", "as-b")),
                                        "beat": st.one_of(st.integers(0, 6), st.just("x"),
                                                          st.none())}))


@settings(max_examples=300, deadline=None)
@given(st.floats(0.5, 5.0), st.lists(st.tuples(ROWS, st.floats(0.0, 3.0)), max_size=12))
def test_leader_gate_equals_jax(stale_after, history):
    port, ref = reconcile.LeaderGate("me", stale_after), jreconcile.LeaderGate("me", stale_after)
    now = 0.0
    for row, dt in history:
        now += dt
        assert port.observe(row, now) == ref.observe(row, now)
        assert port.leading == ref.leading


# ----------------------------------------------------------------- daemon --


class FakeLauncher(ReplicaLauncher):
    """Records actuations; replicas never actually boot — tests publish
    (or withhold) the serve/ row themselves."""

    def __init__(self):
        self.spawned = []  # (rid, version)
        self.drained = []
        self._seq = itertools.count()

    def prestage(self, version):
        pass

    def spawn(self, version):
        rid = f"fake{next(self._seq)}"
        self.spawned.append((rid, version))
        return rid

    def drain(self, replica_id):
        self.drained.append(replica_id)


@pytest.fixture()
def plane():
    p = _Plane("port")
    yield p
    p.close()


@pytest.fixture()
def jax_untouched():
    """Nothing the port's autoscaler does lands in JAX's ring or gauges."""
    kinds = ("autoscale_scale_up", "autoscale_scale_down", "autoscale_takeover")
    counts = jevents.recorder().counts()
    before = ({k: counts.get(k, 0) for k in kinds}, jmetrics.AUTOSCALE_ALERT_TO_READY.count,
              jmetrics.AUTOSCALE_ACTIONS_TOTAL.labels(action="spawn").value)
    yield
    counts = jevents.recorder().counts()
    assert ({k: counts.get(k, 0) for k in kinds}, jmetrics.AUTOSCALE_ALERT_TO_READY.count,
            jmetrics.AUTOSCALE_ACTIONS_TOTAL.labels(action="spawn").value) == before


def _port_events(type_: str, since: int) -> list:
    return [e for e in events.recorder().events(type_=type_) if e.seq > since]


def _mark() -> int:
    evs = events.recorder().events()
    return evs[-1].seq if evs else 0


@pytest.mark.usefixtures("jax_untouched")
class TestAutoscalerDaemon:
    def make(self, plane, spec, autoscaler_id="as-test", **kw):
        launcher = FakeLauncher()
        # interval=30 keeps the fleet row's REAL lease far from the
        # test's fake clocks; watch=False pins the GetValues path (the
        # stream path is exercised end to end by the chaos rung).
        scaler = daemon.Autoscaler(plane.addr, spec, launcher, autoscaler_id=autoscaler_id,
                                   interval=30.0, pool=plane.pool, watch=False, **kw)
        return scaler, launcher

    def serve_row(self, plane, rid, ready=True, version="", queue_depth=0, free_slots=1):
        plane.put(f"serve/{rid}", {
            "endpoint": "127.0.0.1:1", "ready": ready, "version": version,
            "queue_depth": queue_depth, "free_slots": free_slots, "max_batch": 1})

    def fleet_row(self, plane):
        return plane.rows("fleet").get("fleet/autoscaler")

    def test_tick_repairs_to_min_and_publishes_beating_row(self, plane):
        scaler, launcher = self.make(plane, reconcile.FleetSpec(min_replicas=1, max_replicas=2))
        spawns = M.AUTOSCALE_ACTIONS_TOTAL.labels(action="spawn").value
        try:
            summary = scaler.tick_once(now=0.0)
            assert summary["leader"] and summary["target"] == 1
            assert launcher.spawned == [("fake0", "")]
            row = self.fleet_row(plane)
            assert row["autoscaler"] == "as-test"
            assert row["desired"] == 1 and row["ready"] == 0
            assert row["min"] == 1 and row["max"] == 2
            beat0 = row["beat"]
            scaler.tick_once(now=1.0)
            assert launcher.spawned == [("fake0", "")]
            assert self.fleet_row(plane)["beat"] > beat0
            self.serve_row(plane, "fake0")
            summary = scaler.tick_once(now=2.0)
            assert summary["ready"] == 1
            assert self.fleet_row(plane)["ready"] == 1
            assert M.AUTOSCALE_REPLICAS_DESIRED.value == 1
            assert M.AUTOSCALE_REPLICAS_READY.value == 1
            assert M.AUTOSCALE_ACTIONS_TOTAL.labels(action="spawn").value == spawns + 1
        finally:
            scaler.stop(deregister=True)
        assert self.fleet_row(plane) is None  # clean stop deletes

    def test_alert_scale_up_tracks_alert_to_ready(self, plane):
        spec = reconcile.FleetSpec(min_replicas=1, max_replicas=2, cooldown_s=10.0)
        scaler, launcher = self.make(plane, spec)
        observed0 = M.AUTOSCALE_ALERT_TO_READY.count
        mark = _mark()
        try:
            self.serve_row(plane, "r0")
            assert scaler.tick_once(now=0.0)["target"] == 1
            assert launcher.spawned == []
            plane.put("alert/first_token_p99", {"state": "firing", "direction": "up",
                                                "slo": "first_token_p99", "burn_fast": 20.0})
            summary = scaler.tick_once(now=20.0)
            assert summary["target"] == 2
            assert launcher.spawned == [("fake0", "")]
            up = _port_events(events.AUTOSCALE_SCALE_UP, mark)
            assert up and up[-1].attrs["reason"] == "alert:first_token_p99"
            scaler.tick_once(now=21.0)
            assert launcher.spawned == [("fake0", "")]
            assert M.AUTOSCALE_ALERT_TO_READY.count == observed0
            self.serve_row(plane, "fake0")
            assert scaler.tick_once(now=23.5)["ready"] == 2
            assert M.AUTOSCALE_ALERT_TO_READY.count == observed0 + 1
        finally:
            scaler.stop(deregister=True)

    def test_pending_spawn_times_out_into_repair(self, plane):
        scaler, launcher = self.make(
            plane, reconcile.FleetSpec(min_replicas=1, max_replicas=1), pending_timeout_s=5.0)
        try:
            scaler.tick_once(now=0.0)
            scaler.tick_once(now=4.0)
            assert launcher.spawned == [("fake0", "")]
            scaler.tick_once(now=10.0)
            assert launcher.spawned == [("fake0", ""), ("fake1", "")]
        finally:
            scaler.stop(deregister=True)

    def test_standby_defers_then_takes_over_adopting_target(self, plane):
        leader, _ = self.make(plane, reconcile.FleetSpec(min_replicas=2, max_replicas=3),
                              autoscaler_id="as-a")
        standby, st_launcher = self.make(
            plane, reconcile.FleetSpec(min_replicas=1, max_replicas=3),
            autoscaler_id="as-b", stale_after_s=2.0)
        mark = _mark()
        try:
            assert leader.tick_once(now=0.0)["target"] == 2
            assert self.fleet_row(plane)["desired"] == 2
            assert not standby.tick_once(now=100.0)["leader"]
            assert not standby.tick_once(now=101.9)["leader"]
            assert st_launcher.spawned == []
            summary = standby.tick_once(now=102.1)
            assert summary["leader"]
            assert summary["target"] == 2
            assert [v for _, v in st_launcher.spawned] == ["", ""]
            takeovers = [e for e in _port_events(events.AUTOSCALE_TAKEOVER, mark)
                         if e.attrs["autoscaler"] == "as-b"]
            assert len(takeovers) == 1
            assert takeovers[0].attrs["adopted_target"] == 2
            assert self.fleet_row(plane)["autoscaler"] == "as-b"
        finally:
            leader.stop(deregister=False)
            standby.stop(deregister=True)

    def test_clean_stop_promotes_standby_instantly(self, plane):
        leader, _ = self.make(plane, reconcile.FleetSpec(min_replicas=1, max_replicas=1),
                              autoscaler_id="as-a")
        standby, _ = self.make(plane, reconcile.FleetSpec(min_replicas=1, max_replicas=1),
                               autoscaler_id="as-b", stale_after_s=3600.0)
        try:
            leader.tick_once(now=0.0)
            assert not standby.tick_once(now=0.0)["leader"]
            leader.stop(deregister=True)
            assert self.fleet_row(plane) is None
            assert standby.tick_once(now=0.1)["leader"]
            assert self.fleet_row(plane)["autoscaler"] == "as-b"
        finally:
            leader.stop(deregister=False)
            standby.stop(deregister=True)

    def test_garbage_fleet_row_does_not_fence(self, plane):
        plane.stub.SetValue(plane.pb.SetValueRequest(value=plane.pb.Value(
            path="fleet/autoscaler", value="{not json", lease_seconds=60.0)), timeout=5.0)
        scaler, _ = self.make(plane, reconcile.FleetSpec(min_replicas=0, max_replicas=1))
        try:
            assert scaler.tick_once(now=0.0)["leader"]
        finally:
            scaler.stop(deregister=True)

    def test_drain_and_upgrade_flip_land_in_the_ports_ring(self, plane):
        """A rolling upgrade at max capacity drains the stale replica
        first: ``autoscale_scale_down`` and ``autoscale_upgrade_flip``."""
        spec = reconcile.FleetSpec(min_replicas=1, max_replicas=1, version="v2",
                                   cooldown_s=0.0)
        scaler, launcher = self.make(plane, spec)
        mark = _mark()
        try:
            self.serve_row(plane, "old", version="v1")
            scaler.tick_once(now=0.0)
            assert launcher.drained == ["old"]
            assert [e.attrs["reason"] for e in _port_events(events.AUTOSCALE_SCALE_DOWN,
                                                            mark)] == ["upgrade"]
            assert [e.attrs["version"] for e in _port_events(events.AUTOSCALE_UPGRADE_FLIP,
                                                             mark)] == ["v2"]
        finally:
            scaler.stop(deregister=True)


def test_fleet_key_refuses_as_jax():
    assert daemon.fleet_key("x") == jdaemon.fleet_key("x") == "fleet/x"
    for bad in ("", "a/b"):
        with pytest.raises(ValueError):
            daemon.fleet_key(bad)
        with pytest.raises(ValueError):
            jdaemon.fleet_key(bad)


# ------------------------------------------------------- across packages --


def _telemetry(plane, burst: bool) -> None:
    """A replica row whose first tokens are slow during a burst."""
    le = list(jmetrics.DEFAULT_BUCKETS)
    n = 40 if burst else 10
    counts = [0] * 6 + [n] * 6 if not burst else [0] * 6 + [2] * 3 + [n] * 3
    plane.put("telemetry/r0", {"hist": {"first_token": {"le": le, "counts": counts,
                                                        "sum": 1.0 * n}}})


@pytest.mark.parametrize("monitor_pkg", ["jax", "port"])
def test_a_monitor_of_one_package_scales_the_others_fleet(monitor_pkg):
    """The monitor of one package raises ``alert/first_token_p99`` in its
    own package's registry; the other package's autoscaler, reading the
    same registry, spawns on it with reason ``alert:first_token_p99``."""
    mon_mod, slo_mod = (jmonitor, jslo) if monitor_pkg == "jax" else (monitor, slo)
    scaler_mod, rec_mod = (daemon, reconcile) if monitor_pkg == "jax" else \
        (jdaemon, jreconcile)
    plane = _Plane(monitor_pkg)
    engine = slo_mod.SloEngine([slo_mod.SLO(name="first_token_p99", kind="latency",
                                            objective=0.99, metric="first_token",
                                            threshold_s=0.1)],
                               fast_window_s=5.0, slow_window_s=20.0, burn_threshold=10.0,
                               resolve_hold_s=1.0)
    mon = mon_mod.FleetMonitor(plane.addr, engine, interval=30.0, pool=plane.pool,
                               watch=False)
    launcher = FakeLauncher()
    scaler = scaler_mod.Autoscaler(plane.addr, rec_mod.FleetSpec(min_replicas=1,
                                                                 max_replicas=2),
                                   launcher, autoscaler_id="as-x", interval=30.0,
                                   pool=plane.pool, watch=False)
    try:
        plane.put("serve/r0", {"endpoint": "127.0.0.1:1", "ready": True, "queue_depth": 0,
                               "free_slots": 1, "max_batch": 1})
        _telemetry(plane, burst=False)
        assert mon.tick_once(now=0.0) == []
        assert scaler.tick_once(now=0.0)["actions"] == []
        _telemetry(plane, burst=True)
        assert [t["transition"] for t in mon.tick_once(now=10.0)] == ["fired"]
        alert = plane.rows("alert")["alert/first_token_p99"]
        assert alert["direction"] == "up" and alert["state"] == "firing"
        summary = scaler.tick_once(now=10.0)
        assert [(a.kind, a.reason) for a in summary["actions"]] == [
            ("spawn", "alert:first_token_p99")]
        assert summary["target"] == 2 and launcher.spawned == [("fake0", "")]
        assert plane.rows("fleet")["fleet/autoscaler"]["alerts"] == ["first_token_p99"]
    finally:
        scaler.stop(deregister=True)
        mon.stop(deregister=True)
        plane.close()


# --------------------------------------------------- the subprocess launcher --


def test_subprocess_launcher_forks_the_ports_daemon(plane, tmp_path):
    import torch

    from oim_tpu_torch.models import llama
    from oim_tpu_torch.serve import weights
    from oim_tpu_torch.train import TrainConfig

    cfg = TrainConfig(model="llama-tiny").model_config()
    packed = str(tmp_path / "w.oimw")
    weights.save_packed(llama.init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                        packed)
    launcher = SubprocessLauncher(
        ["--weights-file", packed, "--backend", "malloc", "--device", "cpu",
         "--registry", plane.addr, "--endpoint", "tcp://127.0.0.1:0", "--heartbeat", "0.2",
         "--max-batch", "1", "--max-seq", "64", "--log-level", "error"],
        serve_id_prefix="auto", python=sys.executable)
    rid = launcher.spawn("")
    proc = launcher._procs[rid]
    try:
        assert rid == "auto-0"
        assert proc.args[:3] == [sys.executable, "-m", "oim_tpu_torch.cli.oim_serve"]
        assert proc.args[-2:] == ["--serve-id", "auto-0"]
        deadline = time.monotonic() + 120
        while "serve/auto-0" not in plane.rows("serve"):
            assert proc.poll() is None, f"oim-serve exited {proc.returncode}"
            assert time.monotonic() < deadline, "serve/auto-0 never registered"
            time.sleep(0.1)
        row = plane.rows("serve")["serve/auto-0"]
        assert row["ready"] and row["max_batch"] == 1
        launcher.drain(rid)
        assert proc.wait(timeout=60) == 0
        assert "serve/auto-0" not in plane.rows("serve")
    finally:
        launcher.shutdown(timeout=30)
    launcher.drain(rid)  # a drain of a gone replica only warns


# -------------------------------------------------------------------- CLIs --


@pytest.mark.parametrize("port,ref", [(oim_autoscaler, joim_autoscaler),
                                      (oim_registry, joim_registry),
                                      (oim_router, joim_router)],
                         ids=["oim_autoscaler", "oim_registry", "oim_router"])
def test_cli_parser_equals_jax(port, ref):
    assert parser_of(port.main) == parser_of(ref.main)
