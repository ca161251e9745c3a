"""The port's copies of the registry (``oim_tpu_torch/registry``) and the
router (``oim_tpu_torch/router``) held against ``oim_tpu``'s on the CPU.

* Each file equals JAX's source once ``oim_tpu.`` reads
  ``oim_tpu_torch.``, but for the lines listed below by content, each with
  its reason.
* A registry pair and a 3-node quorum built from the port's copies emit
  ``registry_promotion``, ``registry_election`` and ``registry_stepdown``
  into the port's flight recorder and none into JAX's; their promotion
  counter is the port's.
* The port's ``ReplicaTable`` reads a JAX replica's ``serve/`` row as
  JAX's table does, and JAX's reads the port's, from either package's
  registry.
* The counterparts of tests/test_chaos.py's ``TestRouterFaultPoints`` and
  ``TestRegistryPromoteFaultPoint``, armed through the port's
  ``faultinject``; a point armed in one package never fires in the other.
"""

from __future__ import annotations

import dataclasses
import difflib
import time
from collections import Counter
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
import torch

from oim_tpu.common import events as jevents
from oim_tpu.common import faultinject as jfault
from oim_tpu.common import metrics as jmetrics
from oim_tpu.models import llama as jllama
from oim_tpu.registry import MemRegistryDB as JMemRegistryDB
from oim_tpu.registry import RegistryService as JRegistryService
from oim_tpu.registry.registry import registry_server as jregistry_server
from oim_tpu.router import ReplicaTable as JReplicaTable
from oim_tpu.router.router import RouterService as JRouterService
from oim_tpu.serve import ServeEngine as JServeEngine
from oim_tpu.serve.registration import ServeRegistration as JServeRegistration
from oim_tpu_torch.chaos.sim import ClusterSim, wait_for
from oim_tpu_torch.common import events, faultinject
from oim_tpu_torch.common import metrics as M
from oim_tpu_torch.common.rpcfault import InjectedRpcError
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.registry import MemRegistryDB, RegistryService
from oim_tpu_torch.registry.registry import registry_server
from oim_tpu_torch.registry.replication import PRIMARY, STANDBY, ReplicationManager
from oim_tpu_torch.router import ReplicaTable
from oim_tpu_torch.router.router import RouterService
from oim_tpu_torch.router.table import Replica
from oim_tpu_torch.serve import ServeEngine
from oim_tpu_torch.serve.registration import ServeRegistration

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parent.parent

_SPEC = ("the port's spec package holds the params dataclasses; the wire is "
         "spec.oim_pb2 and spec.services, so the spec package loads without grpcio")
_METHOD_LABEL = ("the port keeps the RPC interceptors and method_label in "
                 "common/rpctelemetry.py, so common/tracing.py loads without grpcio")
PB = "from oim_tpu_torch.spec import oim_pb2 as pb"

# file -> [(JAX's line after the prefix rewrite, or None; the port's line,
#           or None; why)]
LISTED: dict[str, list[tuple[str | None, str | None, str]]] = {
    "registry/__init__.py": [],
    "registry/db.py": [],
    "registry/leases.py": [],
    "registry/watch.py": [
        ("from oim_tpu_torch.spec import pb", PB, _SPEC),
    ],
    "registry/registry.py": [
        (None, "from oim_tpu_torch.common.rpctelemetry import method_label", _METHOD_LABEL),
        ("from oim_tpu_torch.spec import (", PB, _SPEC),
        (None, "from oim_tpu_torch.spec.services import (", _SPEC),
        ("    pb,", None, _SPEC),
        ('                f"proxy:{tracing.method_label(method)}", parent=parent,',
         '                f"proxy:{method_label(method)}", parent=parent,', _METHOD_LABEL),
    ],
    "registry/replication.py": [
        ("from oim_tpu_torch.spec import RegistryStub, pb", PB, _SPEC),
        (None, "from oim_tpu_torch.spec.services import RegistryStub", _SPEC),
    ],
    "registry/quorum.py": [
        ("from oim_tpu_torch.spec import RegistryStub, pb", PB, _SPEC),
        (None, "from oim_tpu_torch.spec.services import RegistryStub", _SPEC),
    ],
    "router/__init__.py": [],
    "router/table.py": [
        ("from oim_tpu_torch.spec import RegistryStub, pb", PB, _SPEC),
        (None, "from oim_tpu_torch.spec.services import RegistryStub", _SPEC),
    ],
    "router/router.py": [
        ("from oim_tpu_torch.spec import add_identity_to_server, pb", PB, _SPEC),
        (None, "from oim_tpu_torch.spec.services import add_identity_to_server", _SPEC),
    ],
}


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.reset()
    jfault.reset()
    yield
    faultinject.reset()
    jfault.reset()


@pytest.fixture(autouse=True, scope="module")
def _watch_streams_end():
    """The registries' Watch handlers notice a stopped server at their next
    keepalive (2 s): wait them out, so no RPC of this file counts into a
    later one's metrics."""
    yield
    time.sleep(2.5)


# ----------------------------------------------------------------- copies --


def test_every_file_of_both_packages_is_listed():
    for pkg in ("registry", "router"):
        jax_files = {p.name for p in (_ROOT / "oim_tpu" / pkg).glob("*.py")}
        port_files = {p.name for p in (_ROOT / "oim_tpu_torch" / pkg).glob("*.py")}
        assert jax_files == port_files == {k.split("/")[1] for k in LISTED
                                           if k.startswith(pkg + "/")}


@pytest.mark.parametrize("rel", sorted(LISTED))
def test_copy_equals_jax_source_but_the_listed_lines(rel):
    jax_lines = (_ROOT / "oim_tpu" / rel).read_text().replace(
        "oim_tpu.", "oim_tpu_torch.").splitlines()
    port_lines = (_ROOT / "oim_tpu_torch" / rel).read_text().splitlines()
    removed, added = Counter(), Counter()
    ops = difflib.SequenceMatcher(None, jax_lines, port_lines, autojunk=False).get_opcodes()
    for tag, i1, i2, j1, j2 in ops:
        if tag != "equal":
            removed.update(jax_lines[i1:i2])
            added.update(port_lines[j1:j2])
    assert removed == Counter(j for j, _, _ in LISTED[rel] if j is not None)
    assert added == Counter(p for _, p, _ in LISTED[rel] if p is not None)
    assert all(why for _, _, why in LISTED[rel])


# ------------------------------------------------------------ the rings ----


HEAL_TYPES = ("registry_promotion", "registry_election", "registry_stepdown",
              "registry_demotion")


def _jax_counts():
    counts = jevents.recorder().counts()
    return {t: counts.get(t, 0) for t in HEAL_TYPES}


def test_pair_promotion_lands_in_the_ports_ring_only():
    jbefore = _jax_counts()
    jpromos = jmetrics.REGISTRY_PROMOTIONS.value
    promos = M.REGISTRY_PROMOTIONS.value
    with ClusterSim(replicas=0, registry_pair=True, primary_lease_s=0.3,
                    device="cpu") as sim:
        mark = sim.mark_faults()
        sim.kill_registry_primary()
        assert sim.wait_heal([events.REGISTRY_PROMOTION], mark, timeout=20) == [
            "registry_promotion"]
        assert events.recorder().counts()["registry_promotion"] >= 1
    assert M.REGISTRY_PROMOTIONS.value == promos + 1
    assert jmetrics.REGISTRY_PROMOTIONS.value == jpromos
    assert _jax_counts() == jbefore


def test_quorum_election_and_stepdown_land_in_the_ports_ring_only():
    jbefore = _jax_counts()
    with ClusterSim(replicas=0, registry_quorum=3, device="cpu") as sim:
        leader = sim.registry_leader()
        mark = sim.mark_faults()
        sim.partition_registry([leader[2].node_id])
        expect = [events.REGISTRY_ELECTION, events.REGISTRY_PROMOTION,
                  events.REGISTRY_STEPDOWN]
        assert sim.wait_heal(expect, mark, timeout=20) == expect
        sim.heal_registry_partition()
        assert wait_for(lambda: leader[2].role == "FOLLOWER", timeout=20)
    assert _jax_counts() == jbefore


# ---------------------------------------------------- the serve/ row ----


@pytest.fixture(scope="module")
def engines():
    jcfg = jllama.tiny(vocab=64, dim=32, n_layers=2)
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(np.asarray, jp)
    tcfg = tllama.tiny(vocab=64, dim=32, n_layers=2)
    jeng = JServeEngine(jp, jcfg, max_batch=2, max_seq=64, queue_depth=8, name="jx")
    teng = ServeEngine(tllama.from_numpy(host, device="cpu"), tcfg, max_batch=2, max_seq=64,
                       queue_depth=8, name="pt", device="cpu")
    yield jeng, teng
    jeng.stop(drain=False, timeout=30)
    teng.stop(drain=False, timeout=30)


@pytest.mark.parametrize("registry_pkg", ["jax", "port"])
def test_each_table_lists_the_other_packages_serve_row(engines, registry_pkg):
    jeng, teng = engines
    if registry_pkg == "jax":
        service = JRegistryService(db=JMemRegistryDB())
        server = jregistry_server("tcp://localhost:0", service)
    else:
        service = RegistryService(db=MemRegistryDB())
        server = registry_server("tcp://localhost:0", service)
    service.watch.keepalive = 0.02
    regs = [JServeRegistration("jx", "127.0.0.1:1", jeng, server.addr, version="v1"),
            ServeRegistration("pt", "127.0.0.1:2", teng, server.addr, version="v1")]
    try:
        for reg in regs:
            reg.beat_once()
        tables = [JReplicaTable(server.addr), ReplicaTable(server.addr)]
        for table in tables:
            table.refresh()
        rows = [{r.replica_id: dataclasses.asdict(r) for r in t.replicas()} for t in tables]
        assert set(rows[0]) == set(rows[1]) == {"jx", "pt"}
        assert rows[0] == rows[1]
        assert rows[1]["pt"]["endpoint"] == "127.0.0.1:2" and rows[1]["jx"]["version"] == "v1"
    finally:
        for reg in regs:
            reg.stop(deregister=True)
        wait_for(lambda: not service.watch._streams, 5)
        server.force_stop()


# ------------------------------------------------------- fault points ----


class TestRouterFaultPoints:
    def test_router_stream_injected_unavailable_takes_retry_path(self):
        """An armed InjectedRpcError at router.stream exercises the
        pre-first-token retry contract with no process to kill: the
        faulted replica is marked failed, the retry lands on the peer,
        the client sees nothing."""

        class _Table:
            def __init__(self):
                self.failed = []
                self.rows = [
                    Replica("ra", "127.0.0.1:1", free_slots=9),
                    Replica("rb", "127.0.0.1:2", free_slots=1),
                ]

            def replicas(self):
                return [r for r in self.rows
                        if r.replica_id not in self.failed]

            def mark_failed(self, rid):
                self.failed.append(rid)
                events.emit(events.ROUTER_MARK_FAILED, replica=rid,
                            routable=len(self.replicas()))

        table = _Table()
        service = RouterService(table, affinity=False)
        # ra scores best; the armed fault fails its stream open.
        faultinject.arm(
            "router.stream",
            exc=InjectedRpcError(grpc.StatusCode.UNAVAILABLE, "blackhole"),
            times=1, replica="ra")
        picked = service.pick()
        assert picked.replica_id == "ra"
        attempts = list(service._one_attempt(picked, b"", None, None))
        assert len(attempts) == 1
        kind, err = attempts[0]
        assert kind == "err"
        assert err.code() is grpc.StatusCode.UNAVAILABLE
        assert faultinject.fired("router.stream") == 1

    def test_router_pick_point_unarmed_is_noop_armed_raises(self):
        class _Empty:
            def replicas(self):
                return []

        service = RouterService(_Empty(), affinity=False)
        assert service.pick() is None  # unarmed: plain behavior
        faultinject.arm("router.pick", times=1)
        with pytest.raises(faultinject.InjectedFault):
            service.pick()

    def test_a_point_armed_in_one_package_is_not_armed_in_the_other(self):
        class _Empty:
            def replicas(self):
                return []

        jfault.arm("router.pick", times=1)
        assert RouterService(_Empty(), affinity=False).pick() is None
        assert jfault.fired("router.pick") == 0
        with pytest.raises(jfault.InjectedFault):
            JRouterService(_Empty(), affinity=False).pick()
        faultinject.arm("router.pick", times=1)
        assert JRouterService(_Empty(), affinity=False).pick() is None
        assert faultinject.fired("router.pick") == 0
        with pytest.raises(faultinject.InjectedFault):
            RouterService(_Empty(), affinity=False).pick()


class TestRegistryPromoteFaultPoint:
    def test_watchdog_retries_a_lost_promotion(self):
        """registry.promote armed with times=N delays convergence by N
        watchdog ticks — the promotion still happens, deterministically
        later."""
        p_svc = RegistryService(db=MemRegistryDB())
        p_srv = registry_server("tcp://localhost:0", p_svc)
        s_svc = RegistryService(db=MemRegistryDB())
        s_srv = registry_server("tcp://localhost:0", s_svc)
        p_mgr = ReplicationManager(
            p_svc, peer=s_srv.addr, role=PRIMARY,
            primary_lease_seconds=0.3, boot_grace_seconds=5.0)
        s_mgr = ReplicationManager(
            s_svc, peer=p_srv.addr, role=STANDBY,
            primary_lease_seconds=0.3, boot_grace_seconds=5.0)
        try:
            p_mgr.start(initial_probe=False)
            s_mgr.start(initial_probe=False)
            assert wait_for(s_mgr._may_auto_promote, timeout=15)
            faultinject.arm("registry.promote", times=2, role=STANDBY)
            p_mgr.stop()
            p_srv.force_stop()
            assert wait_for(lambda: s_mgr.role == PRIMARY, timeout=15), \
                "promotion never converged past the injected losses"
            assert faultinject.fired("registry.promote") == 2
            assert jfault.fired("registry.promote") == 0
        finally:
            for mgr in (p_mgr, s_mgr):
                try:
                    mgr.stop()
                except Exception:  # noqa: BLE001 - teardown
                    pass
            for srv in (p_srv, s_srv):
                srv.force_stop()
