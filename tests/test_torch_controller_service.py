"""The port's ``ControllerService`` held against the JAX package's: the same
requests through JAX's ``ControllerService`` over ``TPUBackend`` (on the
CPU) or ``MallocBackend``, and through the port's over
``CUDABackend(device="cpu")`` or ``MallocBackend``, give the same replies,
``ReadVolume`` chunk streams and abort codes.

* MapVolume (idempotent re-map, conflicting params, a FAILED volume
  retried), StageStatus, UnmapVolume, PrestageVolume,
  Provision/CheckMallocBDev.
* ReadVolume of uint8/int32/float32/bfloat16 volumes: whole, 7,013-byte
  unaligned windows, the tail through ``length=0``, an empty window at the
  end, ``chunk_bytes`` 0, negative, small and over ``MAX_READ_CHUNK``,
  with and without ``accept_compressed``; a volume placed over a
  ``plane.LocalMesh`` of eight CPU devices against ``TPUBackend`` over a
  ``data=8`` mesh, and a rank's slice of a mesh, which refuses.
* Every abort path's code.
* The controller's registration and heartbeat loop against JAX's
  in-process ``RegistryService``, ``controller_capabilities``, and
  ``controller_server`` under mTLS, where a wrong CN gets
  ``PERMISSION_DENIED`` on the direct path as in JAX.
"""

from __future__ import annotations

import time

import grpc
import jax
import numpy as np
import pytest
import torch

from oim_tpu.common import faultinject as jfault
from oim_tpu.common.meshcoord import MeshCoord as JMeshCoord
from oim_tpu.controller import controller as jcontroller
from oim_tpu.controller.malloc_backend import MallocBackend as JMallocBackend
from oim_tpu.controller.tpu_backend import TPUBackend
from oim_tpu.parallel import build_mesh as jbuild_mesh
from oim_tpu.registry import MemRegistryDB, RegistryService
from oim_tpu.registry.registry import registry_server
from oim_tpu.spec import pb
from oim_tpu.spec.services import ControllerStub
from oim_tpu_torch.common import faultinject as tfault
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common import metrics as tmetrics
from oim_tpu_torch.common import tlsutil as ttlsutil
from oim_tpu_torch.common.meshcoord import MeshCoord as TMeshCoord
from oim_tpu_torch.controller import CUDABackend, MallocBackend
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.data import plane
from oim_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


class Abort(Exception):
    def __init__(self, code, details):
        super().__init__(f"{code.name}: {details}")
        self.code = code


class Ctx:
    """An in-process servicer context: abort raises."""

    def abort(self, code, details):
        raise Abort(code, details)


def outcome(fn, *args):
    """("ok", reply) or ("abort", code name)."""
    try:
        return "ok", fn(*args, Ctx())
    except Abort as e:
        return "abort", e.code.name


def stream(service, **req):
    """A ReadVolume stream as comparable tuples, or the abort code."""
    try:
        chunks = list(service.ReadVolume(pb.ReadVolumeRequest(**req), Ctx()))
    except Abort as e:
        return e.code.name
    return [(c.data, c.offset, c.total_bytes, c.spec.SerializeToString(), c.compressed)
            for c in chunks]


def jax_tpu():
    return TPUBackend(devices=[jax.devices()[0]])


PAIRS = {
    "device": (lambda: jcontroller.ControllerService(jax_tpu()),
               lambda: tcontroller.ControllerService(CUDABackend(device="cpu"))),
    "malloc": (lambda: jcontroller.ControllerService(JMallocBackend()),
               lambda: tcontroller.ControllerService(MallocBackend())),
}


@pytest.fixture(params=sorted(PAIRS))
def services(request):
    make_j, make_t = PAIRS[request.param]
    return make_j(), make_t()


def map_ready(service, req):
    """MapVolume, wait for the stage, MapVolume again (the placement with
    the final byte count)."""
    first = outcome(service.MapVolume, req)
    vol = service.get_volume(req.volume_id)
    if vol is not None:
        assert vol.wait(timeout=60)
    return first, outcome(service.MapVolume, req), vol


def first_reply_fields(out):
    kind, reply = out
    if kind != "ok":
        return out
    r = pb.MapVolumeReply()
    r.CopyFrom(reply)
    # Progress at the moment of the call: the bytes landed so far, and the
    # device once the stage has landed.
    r.placement.bytes = 0
    r.placement.device_id = 0
    return kind, r


def status(service, volume_id):
    kind, reply = outcome(service.StageStatus, pb.StageStatusRequest(volume_id=volume_id))
    if kind != "ok":
        return kind, reply
    return kind, (reply.ready, reply.bytes_staged, bool(reply.error), reply.gbps > 0)


# --------------------------------------------------------------- volumes ----

RNG = np.random.default_rng(0)
VOLUMES = {
    "uint8": (RNG.integers(0, 256, 50_000, dtype=np.uint8), "", "raw"),
    "int32": (RNG.integers(-2**31, 2**31 - 1, 12_345, dtype=np.int32), "int32", "npy"),
    "float32": (RNG.standard_normal((96, 37)).astype(np.float32), "float32", "npy"),
    "bfloat16": (RNG.integers(0, 2**16, 20_001, dtype=np.uint16), "bfloat16", "raw"),
}


def volume_request(tmp_path, name, volume_id=None, spec=True):
    data, dtype, fmt = VOLUMES[name]
    path = tmp_path / f"{name}.{fmt}"
    if not path.exists():
        if fmt == "npy":
            np.save(path, data)
        else:
            path.write_bytes(data.tobytes())
    req = pb.MapVolumeRequest(volume_id=volume_id or f"vol-{name}",
                              file=pb.FileParams(path=str(path), format=fmt))
    if spec and dtype:
        req.spec.dtype = dtype
    return req, data.tobytes()


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_map_volume_replies_and_stage_status_match(tmp_path, services, name):
    js, ts = services
    req, raw = volume_request(tmp_path, name)
    j1, j2, jvol = map_ready(js, req)
    t1, t2, tvol = map_ready(ts, req)
    assert first_reply_fields(t1) == first_reply_fields(j1)
    assert t2 == j2 and t2[1].placement.bytes == len(raw)
    assert status(ts, req.volume_id) == status(js, req.volume_id)
    # The same params again: the same placement (idempotent); others: refused.
    assert outcome(ts.MapVolume, req) == outcome(js.MapVolume, req)
    other = pb.MapVolumeRequest()
    other.CopyFrom(req)
    other.spec.shape.append(-1)
    assert outcome(ts.MapVolume, other) == outcome(js.MapVolume, other) == \
        ("abort", "ALREADY_EXISTS")
    unmap = pb.UnmapVolumeRequest(volume_id=req.volume_id)
    assert outcome(ts.UnmapVolume, unmap) == outcome(js.UnmapVolume, unmap)
    assert ts.get_volume(req.volume_id) is None and js.get_volume(req.volume_id) is None
    assert outcome(ts.UnmapVolume, unmap) == outcome(js.UnmapVolume, unmap)  # idempotent
    assert status(ts, req.volume_id) == status(js, req.volume_id) == ("abort", "NOT_FOUND")


def test_failed_volume_is_retried_not_poisoned(tmp_path, services):
    js, ts = services
    path = tmp_path / "late.bin"
    req = pb.MapVolumeRequest(volume_id="late", file=pb.FileParams(path=str(path)))
    for service in (js, ts):
        outcome(service.MapVolume, req)
        assert service.get_volume("late").wait(30)
    assert status(ts, "late") == status(js, "late") == ("ok", (False, 0, True, False))
    read = dict(volume_id="late")
    assert stream(ts, **read) == stream(js, **read) == "INTERNAL"
    path.write_bytes(b"\x01" * 4096)
    jr = map_ready(js, req)[1]  # the FAILED volume is evicted and staged anew
    tr = map_ready(ts, req)[1]
    assert tr == jr and tr[1].placement.bytes == 4096
    assert status(ts, "late")[1][:3] == status(js, "late")[1][:3] == (True, 4096, False)


def test_malloc_volume_and_bdev_rpcs_match(services):
    js, ts = services
    calls = [
        ("ProvisionMallocBDev", pb.ProvisionMallocBDevRequest(bdev_name="m", size=8192)),
        ("ProvisionMallocBDev", pb.ProvisionMallocBDevRequest(bdev_name="m", size=8192)),
        ("ProvisionMallocBDev", pb.ProvisionMallocBDevRequest(bdev_name="m", size=4096)),
        ("ProvisionMallocBDev", pb.ProvisionMallocBDevRequest(bdev_name="", size=1)),
        ("ProvisionMallocBDev", pb.ProvisionMallocBDevRequest(bdev_name="n", size=-1)),
        ("CheckMallocBDev", pb.CheckMallocBDevRequest(bdev_name="m")),
        ("CheckMallocBDev", pb.CheckMallocBDevRequest(bdev_name="ghost")),
        ("CheckMallocBDev", pb.CheckMallocBDevRequest(bdev_name="")),
    ]
    for rpc, req in calls:
        assert outcome(getattr(ts, rpc), req) == outcome(getattr(js, rpc), req), (rpc, req)
    js.backend.buffer("m")[:] = np.arange(8192) % 251
    ts.backend.buffer("m")[:] = np.arange(8192) % 251
    req = pb.MapVolumeRequest(volume_id="m", malloc=pb.MallocParams())
    req.spec.dtype = "int32"
    assert map_ready(ts, req)[1] == map_ready(js, req)[1]
    for read in (dict(volume_id="m"), dict(volume_id="m", offset=5, length=7013)):
        assert stream(ts, **read) == stream(js, **read)
    # Provisioning size 0 deletes the buffer.
    req0 = pb.ProvisionMallocBDevRequest(bdev_name="m", size=0)
    assert outcome(ts.ProvisionMallocBDev, req0) == outcome(js.ProvisionMallocBDev, req0)
    check = pb.CheckMallocBDevRequest(bdev_name="m")
    assert outcome(ts.CheckMallocBDev, check) == outcome(js.CheckMallocBDev, check) == \
        ("abort", "NOT_FOUND")


@pytest.mark.parametrize("req", [
    pb.MapVolumeRequest(file=pb.FileParams(path="/nonexistent")),
    pb.MapVolumeRequest(volume_id="v"),
    pb.MapVolumeRequest(volume_id="v", malloc=pb.MallocParams()),
], ids=["no-volume-id", "no-params", "malloc-without-buffer"])
def test_map_volume_refusals_match(services, req):
    js, ts = services
    jo, to = outcome(js.MapVolume, req), outcome(ts.MapVolume, req)
    if jo[0] == "ok":  # staging itself fails; the volume reports it
        js.get_volume(req.volume_id).wait(30)
        ts.get_volume(req.volume_id).wait(30)
        jo, to = status(js, req.volume_id), status(ts, req.volume_id)
    assert to == jo


def test_prestage_volume_matches(tmp_path, services):
    js, ts = services
    req, _ = volume_request(tmp_path, "int32", volume_id="warm")
    assert outcome(ts.PrestageVolume, req) == outcome(js.PrestageVolume, req)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:  # the detached stage lands in the cache
        if outcome(js.PrestageVolume, req)[1].already_cached and \
                outcome(ts.PrestageVolume, req)[1].already_cached:
            break
        time.sleep(0.01)
    assert outcome(ts.PrestageVolume, req) == outcome(js.PrestageVolume, req) == \
        ("ok", pb.PrestageVolumeReply(already_cached=True))
    assert ts.get_volume("warm") is None  # prestaging creates no volume
    for bad in (pb.MapVolumeRequest(volume_id="w"),
                pb.MapVolumeRequest(volume_id="w", malloc=pb.MallocParams())):
        assert outcome(ts.PrestageVolume, bad) == outcome(js.PrestageVolume, bad)
    assert outcome(ts.PrestageVolume, pb.MapVolumeRequest(
        volume_id="w", malloc=pb.MallocParams()))[1] == "FAILED_PRECONDITION"


class NoCache:
    """A backend with no stage cache (PrestageVolume: UNIMPLEMENTED)."""

    def stage(self, volume, kind, params):
        pass

    def unstage(self, volume):
        pass


def test_prestage_without_a_cache_and_a_stuck_stage_match(tmp_path):
    js = jcontroller.ControllerService(NoCache())
    ts = tcontroller.ControllerService(NoCache())
    req, _ = volume_request(tmp_path, "uint8")
    assert outcome(ts.PrestageVolume, req) == outcome(js.PrestageVolume, req) == \
        ("abort", "UNIMPLEMENTED")
    first_j, first_t = outcome(js.MapVolume, req), outcome(ts.MapVolume, req)
    assert first_t == first_j
    read = dict(volume_id=req.volume_id)
    assert stream(ts, **read) == stream(js, **read) == "FAILED_PRECONDITION"  # STAGING
    assert status(ts, req.volume_id)[1][:3] == status(js, req.volume_id)[1][:3]


READS = [dict(), dict(offset=3, length=7013), dict(offset=7013, length=7013),
         dict(offset=-1), dict(offset=1 << 40), dict(length=1), dict(offset=11, length=0),
         dict(chunk_bytes=1000), dict(chunk_bytes=-5), dict(chunk_bytes=(16 << 20) + 1),
         dict(offset=2, length=9000, chunk_bytes=999, accept_compressed=True),
         dict(accept_compressed=True)]


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_read_volume_streams_match(tmp_path, services, name):
    js, ts = services
    req, raw = volume_request(tmp_path, name)
    map_ready(js, req)
    map_ready(ts, req)
    total = len(raw)
    reads = READS + [dict(offset=total), dict(offset=total + 1), dict(offset=total - 5)]
    for read in reads:
        got = stream(ts, volume_id=req.volume_id, **read)
        assert got == stream(js, volume_id=req.volume_id, **read), read
        if isinstance(got, list) and not read.get("accept_compressed"):
            start = read.get("offset", 0)
            end = total if not read.get("length") else min(start + read["length"], total)
            assert b"".join(c[0] for c in got) == raw[start:end]
    assert stream(ts, volume_id="ghost") == stream(js, volume_id="ghost") == "NOT_FOUND"
    # Windows walked through the volume in 7,013-byte steps reassemble it.
    got, offset = bytearray(), 0
    while offset < total:
        got += b"".join(c[0] for c in stream(ts, volume_id=req.volume_id, offset=offset,
                                              length=7013))
        offset += 7013
    assert bytes(got) == raw


def test_read_volume_chunk_cap_over_a_large_volume(tmp_path, services):
    """A volume over MAX_READ_CHUNK: a chunk_bytes over the cap is clamped,
    a non-positive one takes DEFAULT_READ_CHUNK, as in JAX."""
    js, ts = services
    path = tmp_path / "big.bin"
    path.write_bytes(np.arange((17 << 20) // 4, dtype=np.int32).tobytes())
    req = pb.MapVolumeRequest(volume_id="big", file=pb.FileParams(path=str(path)))
    map_ready(js, req)
    map_ready(ts, req)
    for read in (dict(chunk_bytes=(16 << 20) + 1), dict(chunk_bytes=0),
                 dict(offset=(16 << 20) - 3, length=100, chunk_bytes=40)):
        t = stream(ts, volume_id="big", **read)
        assert [c[1:] for c in t] == [c[1:] for c in stream(js, volume_id="big", **read)]
    assert [len(c[0]) for c in stream(ts, volume_id="big", chunk_bytes=1 << 30)] == \
        [16 << 20, 1 << 20]
    assert ts.MAX_READ_CHUNK == js.MAX_READ_CHUNK
    assert ts.DEFAULT_READ_CHUNK == js.DEFAULT_READ_CHUNK


@pytest.mark.parametrize("axes", [["data", ""], ["", "data"]], ids=["rows", "cols"])
def test_read_volume_over_a_local_mesh_matches_a_jax_mesh(tmp_path, axes):
    """The JAX package's TestShardedReadVolume over both packages: one
    volume scattered over eight devices, read in unaligned windows that
    cut element and shard boundaries, gives the global array's bytes
    without assembling it."""
    js = jcontroller.ControllerService(TPUBackend(mesh=jbuild_mesh([("data", 8)])))
    ts = tcontroller.ControllerService(CUDABackend(
        device="cpu", mesh=plane.LocalMesh([("data", 8)], ["cpu"] * 8)))
    vals = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    path = tmp_path / "sharded.npy"
    np.save(path, vals)
    req = pb.MapVolumeRequest(
        volume_id="vol-sh", file=pb.FileParams(path=str(path), format="npy"),
        spec=pb.ArraySpec(shape=[64, 128], dtype="float32", sharding_axes=axes))
    assert map_ready(ts, req)[1] == map_ready(js, req)[1]
    placed = ts.get_volume("vol-sh").array
    assert isinstance(placed, plane.Placed) and len(placed.shards) == 8
    want = vals.tobytes()
    got, offset = bytearray(), 0
    while offset < len(want):
        t = stream(ts, volume_id="vol-sh", offset=offset, length=7013)
        assert t == stream(js, volume_id="vol-sh", offset=offset, length=7013)
        got += b"".join(c[0] for c in t)
        offset += 7013
    assert bytes(got) == want


def test_a_ranks_slice_of_a_mesh_refuses_a_window(tmp_path):
    mesh = Mesh([("data", 2)], [0, 1], "cpu", rank=0)
    ts = tcontroller.ControllerService(CUDABackend(device="cpu", mesh=mesh))
    vals = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    path = tmp_path / "rank.npy"
    np.save(path, vals)
    req = pb.MapVolumeRequest(
        volume_id="r", file=pb.FileParams(path=str(path), format="npy"),
        spec=pb.ArraySpec(shape=[16, 8], dtype="float32", sharding_axes=["data", ""]))
    map_ready(ts, req)
    assert ts.get_volume("r").array.shards[0][2].shape == (8, 8)
    assert stream(ts, volume_id="r", offset=0, length=16) == "FAILED_PRECONDITION"


def test_controller_capabilities_name_the_backend_and_sources():
    from oim_tpu.controller.source import SOURCES as JSOURCES

    caps = tcontroller.controller_capabilities(
        tcontroller.ControllerService(CUDABackend(device="cpu")))
    assert caps[0] == "backend:cuda"
    assert caps[1:] == [f"source:{s}" for s in JSOURCES]
    assert tcontroller.controller_capabilities(
        tcontroller.ControllerService(MallocBackend())) == \
        jcontroller.controller_capabilities(jcontroller.ControllerService(JMallocBackend()))


# ---------------------------------------------------- registration loop ----


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.fixture
def registry():
    service = RegistryService(db=MemRegistryDB())
    server = registry_server("tcp://localhost:0", service)
    yield server, service
    server.force_stop()
    jfault.reset()
    tfault.reset()


def test_registration_and_heartbeats_match_jax(registry):
    server, service = registry
    made = {}
    for name, mod, backend, coord in (
            ("jax", jcontroller, JMallocBackend(), JMeshCoord.parse("1,2,3")),
            ("port", tcontroller, MallocBackend(), TMeshCoord.parse("1,2,3"))):
        made[name] = mod.Controller(
            controller_id=f"host-{name}", backend=backend,
            controller_address=f"tcp://{name}:1", registry_address=server.addr,
            registry_delay=0.05, mesh_coord=coord)
    rtt0 = tmetrics.HEARTBEAT_RTT.value
    hb = tmetrics.RPC_TOTAL.labels(method="oim.v1.Registry/Heartbeat", code="OK")
    hb0 = hb.value
    for c in made.values():
        c.start()
    try:
        for name in made:
            assert wait_for(lambda: service.db.get(f"host-{name}/mesh") == "1,2,3")
            assert service.db.get(f"host-{name}/address") == f"tcp://{name}:1"
            assert service.leases.remaining(f"host-{name}/address") is not None
        assert made["port"].lease_seconds == made["jax"].lease_seconds == \
            pytest.approx(0.125)
        # Heartbeats renew the lease: rows stay alive past several TTLs.
        assert wait_for(lambda: hb.value >= hb0 + 3)
        assert tmetrics.HEARTBEAT_RTT.value != rtt0
        time.sleep(0.125 * 3)
        for name in made:
            assert wait_for(lambda: service.leases.alive(f"host-{name}/address"), 2.0)
        # An outage (heartbeats and registrations fail), then the registry
        # forgets: both loops re-register on their own.
        for name, fault in (("jax", jfault), ("port", tfault)):
            fault.arm("controller.heartbeat", times=3)
            fault.arm("controller.register", times=3)
        for name, fault in (("jax", jfault), ("port", tfault)):
            assert wait_for(lambda: fault.fired("controller.heartbeat")
                            + fault.fired("controller.register") >= 3)
        for name in made:
            service.db.set(f"host-{name}/address", "")
            service.leases.drop(f"host-{name}/address")
        for name in made:
            assert wait_for(lambda: service.db.get(f"host-{name}/address")
                            == f"tcp://{name}:1")
    finally:
        for c in made.values():
            c.stop()


def test_controller_requires_an_address_to_register():
    for mod, backend in ((jcontroller, JMallocBackend()), (tcontroller, MallocBackend())):
        with pytest.raises(ValueError, match="controller address"):
            mod.Controller("c", backend, registry_address="r:1")


# -------------------------------------------------------------- mTLS ----


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from oim_tpu.common.ca import CertAuthority

    d = tmp_path_factory.mktemp("ctl-certs")
    ca = CertAuthority()
    return d / "ca.crt", {cn: ca.write_files(d, cn) for cn in (
        "controller.host-0", "host.host-0", "host.other", "component.registry",
        "user.admin", "component.feeder")}


@pytest.mark.parametrize("cn", ["host.host-0", "host.other", "component.registry",
                                "user.admin", "component.feeder"])
def test_controller_server_under_mtls_checks_the_caller_as_jax(certs, cn):
    from oim_tpu.common import tlsutil as jtlsutil

    ca, prefixes = certs
    codes = {}
    for name, mod, backend, tls_mod in (
            ("jax", jcontroller, JMallocBackend(), jtlsutil),
            ("port", tcontroller, MallocBackend(), ttlsutil)):
        service = mod.ControllerService(backend, controller_id="host-0")
        server = mod.controller_server("tcp://localhost:0", service,
                                       tls=tls_mod.load_tls(ca, prefixes["controller.host-0"]))
        try:
            client = ttlsutil.load_tls(ca, prefixes[cn])
            channel = ttlsutil.dial(server.addr, client, "controller.host-0")
            got = []
            for call in (
                    lambda s: list(s.ReadVolume(pb.ReadVolumeRequest(volume_id="v"),
                                                timeout=10)),
                    lambda s: s.UnmapVolume(pb.UnmapVolumeRequest(volume_id="v"), timeout=10),
                    lambda s: s.StageStatus(pb.StageStatusRequest(volume_id="v"),
                                            timeout=10)):
                try:
                    call(ControllerStub(channel))
                    got.append("OK")
                except grpc.RpcError as e:
                    got.append(e.code().name)
            channel.close()
            codes[name] = got
        finally:
            server.force_stop()
    assert codes["port"] == codes["jax"]
    denied = cn not in ("host.host-0", "component.registry", "user.admin")
    assert (codes["port"][0] == "PERMISSION_DENIED") == denied


# ------------------------------------------------------------ the daemon ----


def test_oim_controller_cli_registers_and_serves(registry, tmp_path):
    """The port's oim-controller, built from its flags in process: it
    registers with JAX's registry and serves the Controller and Identity
    services, with a --device-mesh of CPU devices for sharded specs."""
    from oim_tpu.spec.services import IdentityStub
    from oim_tpu_torch.cli import oim_controller

    import socket

    server, service = registry
    with socket.socket() as sock:  # a free port, so the address is known up front
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    args = oim_controller.parse_args([
        "--controller-id", "host-cli", "--endpoint", f"tcp://localhost:{port}",
        "--controller-address", f"localhost:{port}", "--registry", server.addr,
        "--registry-delay", "0.05", "--device", "cpu", "--device-mesh", "data=4",
        "--mesh-coord", "0,0,1"])
    controller, cserver = oim_controller.build(args)
    try:
        assert wait_for(lambda: service.db.get("host-cli/address") == f"localhost:{port}")
        assert wait_for(lambda: service.db.get("host-cli/mesh") == "0,0,1")
        backend = controller.service.backend
        assert isinstance(backend, CUDABackend)
        assert backend.mesh == plane.LocalMesh([("data", 4)], ["cpu"] * 4)
        with grpc.insecure_channel(cserver.addr) as ch:
            info = IdentityStub(ch).GetInfo(pb.GetInfoRequest(), timeout=10)
            assert info.name == "oim-controller" and "backend:cuda" in info.capabilities
            vals = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
            np.save(tmp_path / "m.npy", vals)
            ControllerStub(ch).MapVolume(pb.MapVolumeRequest(
                volume_id="m", file=pb.FileParams(path=str(tmp_path / "m.npy"),
                                                  format="npy"),
                spec=pb.ArraySpec(sharding_axes=["data", ""])), timeout=10)
            assert controller.service.get_volume("m").wait(30)
            got = b"".join(c.data for c in ControllerStub(ch).ReadVolume(
                pb.ReadVolumeRequest(volume_id="m", offset=5, length=101), timeout=10))
            assert got == vals.tobytes()[5:106]
            assert len(controller.service.get_volume("m").array.shards) == 4
    finally:
        controller.stop()
        cserver.force_stop()
    with pytest.raises(SystemExit, match="--device-mesh"):
        oim_controller.device_mesh("data=x", "cpu")
    assert oim_controller.device_mesh("", "cpu") is None
