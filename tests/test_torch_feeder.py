"""The port's ``Feeder`` held against the JAX package's: local mode over the
port's ``ControllerService``, and remote mode through JAX's registry proxy
(the registry is a separate, jax-free program: the port has no copy of it)
to the port's controllers.

* ``publish``, ``fetch`` and ``fetch_window`` on the direct and the proxy
  paths, byte for byte against the file and against the JAX Feeder.
* Healing after a controller restart (``NOT_FOUND``, then a re-publish).
* Failover between two port controllers at one coordinate.
* Warm-standby prestage of the replica.
* Interop both ways: the JAX Feeder to a port controller, the port Feeder
  to a JAX controller, byte-identical.
* Observability: the same remote workload in both packages gives equal
  deltas of ``oim_rpc_total``/``oim_rpc_latency_seconds`` by Controller
  method and code, ``STAGE_WAIT_SECONDS``, ``WINDOW_PATH_TOTAL``, ``WINDOW_GBPS``,
  ``CHANNEL_POOL_SIZE`` and ``FEEDER_FAILOVERS``, the ``feeder_failover``
  and ``volume_healed`` events and the ``feeder.publish``/``feeder.window``
  spans. The registry proxies every Controller call with JAX's
  interceptors in both runs, so a run's RPC counts are the sum over both
  packages' registries.
"""

from __future__ import annotations

import collections
import contextlib
import time
import types

import jax
import numpy as np
import pytest
import torch

from oim_tpu.common import channelpool as jchannelpool
from oim_tpu.common import events as jevents
from oim_tpu.common import metrics as jmetrics
from oim_tpu.common import tracing as jtracing
from oim_tpu.common.meshcoord import MeshCoord as JMeshCoord
from oim_tpu.controller import controller as jcontroller
from oim_tpu.controller.malloc_backend import MallocBackend as JMallocBackend
from oim_tpu.controller.tpu_backend import TPUBackend
from oim_tpu.feeder import driver as jdriver
from oim_tpu.registry import MemRegistryDB, RegistryService
from oim_tpu.registry.registry import registry_server
from oim_tpu.spec import pb
from oim_tpu_torch.common import channelpool as tchannelpool
from oim_tpu_torch.common import events as tevents
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import metrics as tmetrics
from oim_tpu_torch.common import tracing as ttracing
from oim_tpu_torch.common.meshcoord import MeshCoord as TMeshCoord
from oim_tpu_torch.controller import CUDABackend, MallocBackend
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.feeder import driver as tdriver

torch.set_num_threads(2)

JAX = types.SimpleNamespace(
    name="jax", controller=jcontroller, backend=JMallocBackend, driver=jdriver,
    M=jmetrics, events=jevents, tracing=jtracing, pool=jchannelpool, coord=JMeshCoord)
PORT = types.SimpleNamespace(
    name="port", controller=tcontroller, backend=lambda: CUDABackend(device="cpu"),
    driver=tdriver, M=tmetrics, events=tevents, tracing=ttracing, pool=tchannelpool,
    coord=TMeshCoord)
PKGS = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    d = tmp_path_factory.mktemp("feeder-vol")
    data = np.random.default_rng(3).integers(0, 1 << 30, 25_000, dtype=np.int32)
    path = d / "tokens.npy"
    np.save(path, data)
    raw = d / "blob.bin"
    raw.write_bytes(np.random.default_rng(4).bytes(60_000))
    return data, str(path), str(raw)


def file_request(path, volume_id="vol", fmt="npy", dtype=""):
    req = pb.MapVolumeRequest(volume_id=volume_id,
                              file=pb.FileParams(path=path, format=fmt))
    if dtype:
        req.spec.dtype = dtype
    return req


def quick_watch(service):
    """A registry whose Watch streams notice a cancelled client at once
    (the hub sends a keepalive each 20 ms, not each 2 s)."""
    service.watch.keepalive = 0.02
    return service


def settle(service, timeout=5.0):
    """Wait until the registry has ended every Watch stream and recorded
    it: a stream ended after this test would count into the next test's
    metric deltas in this process."""
    wait_for(lambda: not service.watch._streams, timeout)
    time.sleep(0.1)


class Cluster:
    """JAX's registry with ``n`` controllers of ``pkg`` registered at one
    mesh coordinate (leases of 2.5 x ``delay``)."""

    def __init__(self, pkg, n=1, delay=0.1):
        self.db = MemRegistryDB()
        self.service = quick_watch(RegistryService(db=self.db))
        self.registry = registry_server("tcp://localhost:0", self.service)
        self.controllers, self.servers = [], []
        for i in range(n):
            self.add(pkg, f"host-{i}", delay)

    def add(self, pkg, cid, delay=0.1):
        c = pkg.controller.Controller(
            controller_id=cid, backend=pkg.backend(), controller_address="pending",
            registry_address=self.registry.addr, registry_delay=delay,
            mesh_coord=pkg.coord.parse("1,2,3"))
        server = pkg.controller.controller_server("tcp://localhost:0", c.service)
        c.controller_address = server.addr
        c.start()
        self.controllers.append(c)
        self.servers.append(server)
        # Generous: a loaded test machine can take seconds to register.
        assert wait_for(lambda: self.db.get(f"{cid}/address") == server.addr, 60)
        return c

    def services(self):
        return [c.service for c in self.controllers]

    def close(self):
        for c in self.controllers:
            c.stop()
        for s in self.servers:
            s.force_stop()
        settle(self.service)
        self.registry.force_stop()


@contextlib.contextmanager
def cluster(pkg, n=1):
    c = Cluster(pkg, n)
    try:
        yield c
    finally:
        c.close()


# ------------------------------------------------------------ local mode ----


def test_local_mode_matches_jax(volume):
    data, path, raw_path = volume
    jf = jdriver.Feeder(controller=jcontroller.ControllerService(
        TPUBackend(devices=[jax.devices()[0]])))
    tf = tdriver.Feeder(controller=tcontroller.ControllerService(CUDABackend(device="cpu")))
    for req in (file_request(path), file_request(raw_path, "raw", "raw")):
        jp, tp = jf.publish(req), tf.publish(req)
        assert (tp.bytes, tp.handle, tp.device_id, tp.coordinate.format()) == \
            (jp.bytes, jp.handle, jp.device_id, jp.coordinate.format())
        assert isinstance(tp.array, torch.Tensor)
        assert tf.publish(req) is tp  # idempotent
        np.testing.assert_array_equal(tf.fetch(req.volume_id), jf.fetch(req.volume_id))
        for offset, length in ((0, 0), (3, 7013), (7013, 7013), (59_990, 100)):
            jw, jt, _ = jf.fetch_window(req.volume_id, offset, length)
            tw, tt, _ = tf.fetch_window(req.volume_id, offset, length)
            assert (tw.tobytes(), tt) == (jw.tobytes(), jt)
    np.testing.assert_array_equal(tf.fetch("vol"), data)
    conflict = file_request(path)
    conflict.spec.dtype = "float32"
    for f in (jf, tf):
        with pytest.raises(f is jf and jdriver.PublishError or tdriver.PublishError,
                           match="different params"):
            f.publish(conflict)
    for f, err in ((jf, jdriver.PublishError), (tf, tdriver.PublishError)):
        with pytest.raises(err) as e:
            f.fetch_window("ghost", 0, 10)
        assert e.value.code == "NOT_FOUND"
        f.unpublish("vol")
        f.unpublish("vol")  # idempotent
        assert f.controller.get_volume("vol") is None


def test_local_fetch_of_bfloat16_refuses_and_windows_serve_its_bytes(volume):
    _, _, raw_path = volume
    tf = tdriver.Feeder(controller=tcontroller.ControllerService(CUDABackend(device="cpu")))
    tf.publish(file_request(raw_path, "bf", "raw", "bfloat16"))
    with pytest.raises(ValueError, match="bfloat16"):
        tf.fetch("bf")
    w, total, spec = tf.fetch_window("bf", 5, 1001)
    assert total == 60_000 and spec.dtype == "bfloat16"
    with open(raw_path, "rb") as f:
        assert w.tobytes() == f.read()[5:1006]


def test_mode_validation_matches_jax():
    for drv, ctl, backend in ((jdriver, jcontroller, JMallocBackend),
                              (tdriver, tcontroller, MallocBackend)):
        with pytest.raises(ValueError):
            drv.Feeder()
        with pytest.raises(ValueError):
            drv.Feeder(controller=ctl.ControllerService(backend()), registry_address="x",
                       controller_id="y")
        with pytest.raises(ValueError):
            drv.Feeder(registry_address="x")


# ----------------------------------------------------------- remote mode ----


@pytest.mark.parametrize("direct", [True, False], ids=["direct", "proxy"])
def test_remote_fetch_and_windows_through_the_proxy_to_the_port(volume, direct):
    data, path, raw_path = volume
    paths = tmetrics.WINDOW_PATH_TOTAL
    with cluster(PORT) as c:
        f = tdriver.Feeder(registry_address=c.registry.addr, controller_id="host-0",
                           direct_data=direct, pool=tchannelpool.ChannelPool())
        try:
            pub = f.publish(file_request(path), timeout=30)
            assert pub.bytes == data.nbytes and pub.array is None
            assert pub.coordinate.format() == "1,2,3"
            before = {p: paths.labels(path=p).value for p in ("direct", "proxy")}
            np.testing.assert_array_equal(f.fetch("vol"), data)
            want = data.tobytes()
            got, offset = bytearray(), 0
            while offset < len(want):
                w, total, spec = f.fetch_window("vol", offset, 7013, heal=True)
                assert total == len(want) and spec.dtype == "int32"
                got += w.tobytes()
                offset += 7013
            assert bytes(got) == want
            n = 1 + -(-len(want) // 7013)
            served = {p: paths.labels(path=p).value - before[p] for p in before}
            assert sum(served.values()) == n
            # The direct path serves whatever it can (a window it cannot
            # serve falls back to the proxy); with it off, the proxy all.
            assert served["direct"] >= (n - 1 if direct else 0) and \
                (direct or served["direct"] == 0)
            f.unpublish("vol")
            assert c.services()[0].get_volume("vol") is None
        finally:
            f.close()


def test_heal_after_a_controller_restart(volume):
    data, path, _ = volume
    with cluster(PORT) as c:
        f = tdriver.Feeder(registry_address=c.registry.addr, controller_id="host-0",
                           pool=tchannelpool.ChannelPool())
        seq = max((e.seq for e in tevents.recorder().events()), default=0)
        try:
            f.publish(file_request(path), timeout=30)
            assert f.fetch_window("vol", 0, 1000)[0].tobytes() == data.tobytes()[:1000]
            # The controller restarts with empty soft state at a new address.
            c.controllers[0].stop()
            c.servers[0].force_stop()
            c.add(PORT, "host-0")
            with pytest.raises(tdriver.PublishError) as e:
                f.fetch_window("vol", 0, 1000, timeout=10)
            assert e.value.code in ("NOT_FOUND", "UNAVAILABLE")
            w, total, _ = f.fetch_window("vol", 1000, 1000, timeout=30, heal=True)
            assert w.tobytes() == data.tobytes()[1000:2000] and total == data.nbytes
            assert c.controllers[-1].service.get_volume("vol") is not None
            assert "volume_healed" in [e.type for e in tevents.recorder().events()
                                       if e.seq > seq]
        finally:
            f.close()


def failover_run(pkg, path):
    """Two controllers of ``pkg`` at one coordinate; host-0 dies after a
    publish, and the next healing window fails over to host-1."""
    with cluster(pkg, 2) as c:
        f = pkg.driver.Feeder(registry_address=c.registry.addr, controller_id="host-0",
                              pool=pkg.pool.ChannelPool())
        try:
            f.publish(file_request(path), timeout=30)
            first = f.fetch_window("vol", 0, 20_000, heal=True)[0].tobytes()
            c.controllers[0].stop()
            c.servers[0].force_stop()
            second = f.fetch_window("vol", 20_000, 20_000, timeout=30, heal=True)[0]
            assert f.controller_id == "host-1"
            assert c.services()[1].get_volume("vol") is not None
            return first + second.tobytes()
        finally:
            f.close()


def test_failover_between_two_port_controllers(volume):
    data, path, _ = volume
    failovers = tmetrics.FEEDER_FAILOVERS.value
    assert failover_run(PORT, path) == data.tobytes()[:40_000]
    assert tmetrics.FEEDER_FAILOVERS.value == failovers + 1


def test_warm_standby_prestages_the_replica(volume):
    _, path, _ = volume
    with cluster(PORT, 2) as c:
        f = tdriver.Feeder(registry_address=c.registry.addr, controller_id="host-0",
                           warm_standby=True, pool=tchannelpool.ChannelPool())
        try:
            req = file_request(path)
            f.publish(req, timeout=30)
            replica = c.services()[1]
            assert replica.get_volume("vol") is None  # warmed, not mapped
            ctx = types.SimpleNamespace(abort=lambda code, details: pytest.fail(details))
            assert wait_for(lambda: replica.PrestageVolume(req, ctx).already_cached, 30)
            assert f.prestage_replica(req) == "host-1"
        finally:
            f.close()


@pytest.mark.parametrize("feeder_pkg,controller_pkg", [("jax", "port"), ("port", "jax")])
def test_interop_is_byte_identical(volume, feeder_pkg, controller_pkg):
    data, path, raw_path = volume
    fp = PKGS[feeder_pkg]
    with cluster(PKGS[controller_pkg]) as c:
        f = fp.driver.Feeder(registry_address=c.registry.addr, controller_id="host-0",
                             pool=fp.pool.ChannelPool())
        try:
            f.publish(file_request(path), timeout=30)
            f.publish(file_request(raw_path, "raw", "raw"), timeout=30)
            np.testing.assert_array_equal(f.fetch("vol"), data)
            with open(raw_path, "rb") as fh:
                blob = fh.read()
            for offset, length in ((0, 0), (3, 7013), (59_000, 5000)):
                w, total, _ = f.fetch_window("raw", offset, length, heal=True)
                end = total if not length else min(offset + length, total)
                assert (w.tobytes(), total) == (blob[offset:end], len(blob))
        finally:
            f.close()


# --------------------------------------------------------- observability ----


def snapshot(pkg):
    out = {}
    for name in ("RPC_TOTAL", "RPC_LATENCY", "WINDOW_PATH_TOTAL", "WINDOW_GBPS",
                 "STAGE_WAIT_SECONDS", "FEEDER_FAILOVERS"):
        fam = getattr(pkg.M, name)
        with fam._family_lock:
            children = list(fam._children.items())
        for key, child in children:
            out[(name, key)] = child.count if isinstance(fam, pkg.M.Histogram) \
                else child.value
    return out


def deltas(before, after):
    out = collections.Counter()
    for key, val in after.items():
        d = val - before.get(key, 0)
        if d:
            out[key] += d
    return out


def workload(pkg, path):
    """Publish, read whole, three windows on each path, unpublish, then a
    failover; returns the metric deltas summed over both packages, the
    pool gauges' delta (both packages'), the events and the feeder spans recorded."""
    before = {p.name: snapshot(p) for p in (JAX, PORT)}
    def pooled():  # the registry's proxy pools its dials in JAX's gauge
        return JAX.M.CHANNEL_POOL_SIZE.value + PORT.M.CHANNEL_POOL_SIZE.value

    gauge = pooled()
    seq = max((e.seq for e in pkg.events.recorder().events()), default=0)
    n_spans = len(pkg.tracing.recorder().spans())
    with cluster(pkg) as c:
        for direct in (True, False):
            f = pkg.driver.Feeder(registry_address=c.registry.addr, controller_id="host-0",
                                  direct_data=direct, pool=pkg.pool.ChannelPool())
            try:
                f.publish(file_request(path), timeout=30)
                f.fetch("vol")
                for offset in (0, 7013, 14_026):
                    f.fetch_window("vol", offset, 7013, heal=True)
                f.unpublish("vol")
                pool_gauge = pooled() - gauge
            finally:
                f.close()
    failover_run(pkg, path)
    total = collections.Counter()
    for p in (JAX, PORT):
        total += deltas(before[p.name], snapshot(p))
    events = [(e.type, sorted(e.attrs)) for e in pkg.events.recorder().events()
              if e.seq > seq and e.type in ("feeder_failover", "volume_healed")]
    spans = collections.Counter(s.name for s in pkg.tracing.recorder().spans()[n_spans:]
                                if s.name.startswith("feeder."))
    return total, pool_gauge, events, spans


def test_the_same_workload_records_equal_deltas(volume):
    _, path, _ = volume
    prev = [(p.tracing.recorder(), p.events.recorder()) for p in (JAX, PORT)]
    for p in (JAX, PORT):
        p.tracing.configure(f"{p.name}-feeder", capacity=1 << 16)
        p.events.configure(capacity=1 << 16)
    try:
        j = workload(JAX, path)
        t = workload(PORT, path)
    finally:
        for p, (spans, evs) in zip((JAX, PORT), prev):
            p.tracing._recorder, p.events._recorder = spans, evs
    def counts(m):
        # RPCs by method and code: the Controller service's, which only this
        # workload calls in this process (a registry call may come from a
        # loop another test file left running). StageStatus is polled
        # until the stage lands: how often is timing, so it is compared
        # in presence.
        out = {}
        for k, v in m.items():
            if k[0] in ("RPC_TOTAL", "RPC_LATENCY"):
                if not k[1][0].startswith("oim.v1.Controller/"):
                    continue
                if k[1][0].endswith("/StageStatus"):
                    v = v > 0
            out[k] = v
        return out

    jm, tm = counts(j[0]), counts(t[0])
    assert tm == jm  # counters and each histogram child's observations
    assert tm[("FEEDER_FAILOVERS", ())] == 1
    assert tm[("RPC_TOTAL", ("oim.v1.Controller/MapVolume", "OK"))] > 0
    assert tm[("RPC_TOTAL", ("oim.v1.Controller/ReadVolume", "OK"))] > 0
    assert tm[("WINDOW_PATH_TOTAL", ("direct",))] > 0
    assert t[1:] == j[1:]
    # The failover, then the replica's re-publish of the volume it never had.
    assert t[2] == [("feeder_failover", ["dead", "reason", "target", "volume"]),
                    ("volume_healed", ["controller", "volume"])]
    assert t[3]["feeder.publish"] >= 2 and t[3]["feeder.window"] >= 6
