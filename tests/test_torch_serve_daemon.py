"""The port's serving daemon held against the JAX package's on the CPU:
``serve/service.py`` (``oim.v1.Serve`` over gRPC), ``serve/registration.py``
(the ``serve/<id>`` row), ``serve/members.py`` (a sharded replica's member
leases), ``serve/weights.py`` (publish and restore through the control
plane) and ``cli/oim_serve.py``.

JAX and the port in one process, llama-tiny in f32, one set of weights
carried by ``from_numpy``; JAX's registry and router (jax-free programs
the port has no copy of) in process, every server on port 0.

* Greedy streams through the port's ``ServeService`` equal JAX's token for
  token, at ``stream_tokens`` 1 and 4; the status codes of a full queue, a
  drain, a cancel and a bad request, and ``serve_capabilities``, equal
  JAX's.
* ``restore_weights`` equals JAX's bitwise, local (over
  ``CUDABackend(device="cpu")``) and remote (through the port's controller
  daemon), whole and as both members of shard 2, with ``LAST_RESTORE``
  field for field; a leaf at an offset its element size does not divide
  is copied, the others are views of the staged volume.
* The serve row and the member rows equal JAX's for the same engine state
  (``prefix_hashes``, ``prefix_tiers`` and ``version`` included), and JAX's
  ``RouterService`` routes to a port replica: the stream equals the direct
  one.
* ``oim_serve.main`` boots from a checkpoint (``--pack-to``), from a
  weights file (local and remote, ``--prestage``, ``--serve-id``,
  ``--shard 2``) and ``--restore-only``, and drains on SIGTERM in JAX's
  order; every refusal is hit, JAX's with JAX's message.

Every stream is ended and waited for before its server stops, and the
registries' Watch streams are settled at teardown (ROADMAP C, trap 12(f)).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import grpc
import jax
import numpy as np
import pytest
import torch

from oim_tpu.cli import oim_serve as jcli
from oim_tpu.common import tlsutil as jtlsutil
from oim_tpu.controller.controller import ControllerService as JControllerService
from oim_tpu.controller.malloc_backend import MallocBackend as JMallocBackend
from oim_tpu.feeder import Feeder as JFeeder
from oim_tpu.models import llama as jllama
from oim_tpu.registry import MemRegistryDB, RegistryService
from oim_tpu.registry.registry import registry_server
from oim_tpu.router import ReplicaTable, RouterService, router_server
from oim_tpu.serve import ServeEngine as JServeEngine
from oim_tpu.serve import registration as jreg
from oim_tpu.serve import service as jservice
from oim_tpu.serve import shard as jshard
from oim_tpu.serve import weights as jweights
from oim_tpu.spec import IdentityStub, RegistryStub, ServeStub, pb
from oim_tpu_torch.cli import oim_serve as tcli
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common.meshcoord import MeshCoord
from oim_tpu_torch.controller import CUDABackend
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.feeder import Feeder as TFeeder
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.serve import ServeEngine as TServeEngine
from oim_tpu_torch.serve import members as tmembers
from oim_tpu_torch.serve import registration as treg
from oim_tpu_torch.serve import service as tservice
from oim_tpu_torch.serve import weights as tweights
from oim_tpu_torch.train import TrainConfig

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


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, JAX cfg, port cfg): llama-tiny, the
    daemon's own config, one set of weights."""
    jcfg = jllama.tiny()
    tcfg = TrainConfig(model="llama-tiny").model_config()
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    return jp, tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), jcfg, tcfg


ENGINE = dict(max_batch=2, max_seq=96, queue_depth=4)


def engines(model, **kw):
    """A JAX and a port engine on the same weights and geometry."""
    jp, tp, jcfg, tcfg = model
    kw = {**ENGINE, **kw}
    return (JServeEngine(jp, jcfg, **kw), TServeEngine(tp, tcfg, device="cpu", **kw))


class Served:
    """An engine behind its package's ``serve_server`` on port 0, with a
    client channel; ``close`` waits for nothing but stops everything."""

    def __init__(self, svc_mod, eng, stream_tokens=1):
        self.eng = eng
        self.server = svc_mod.serve_server(
            "tcp://127.0.0.1:0", svc_mod.ServeService(eng, stream_tokens=stream_tokens))
        self.channel = jtlsutil.dial(self.server.addr, None)
        self.stub = ServeStub(self.channel)

    def generate(self, prompt, n, **kw):
        deltas = list(self.stub.Generate(
            pb.GenerateRequest(prompt=prompt, max_new_tokens=n, **kw), timeout=120))
        return [t for d in deltas for t in d.tokens], deltas

    def close(self):
        self.channel.close()
        self.server.stop()
        self.eng.stop(drain=False, timeout=30)


PROMPTS = ([1, 2, 3], list(range(5, 25)), [7] * 40)


@pytest.mark.parametrize("stream_tokens", [1, 4])
def test_greedy_streams_equal_jax_over_grpc(model, stream_tokens):
    pair = [Served(m, e, stream_tokens) for m, e in zip((jservice, tservice), engines(model))]
    try:
        for prompt in PROMPTS:
            (jt, jd), (tt, td) = (s.generate(prompt, 12) for s in pair)
            assert tt == jt and len(tt) == 12
            assert (td[-1].done, td[-1].finish_reason) == (jd[-1].done, jd[-1].finish_reason) \
                == (True, "length")
            assert not any(d.done for d in td[:-1])
            assert all(len(d.tokens) <= max(stream_tokens, 12) for d in td)
        eos = pair[0].generate(PROMPTS[1], 12)[0][3]
        assert pair[1].generate(PROMPTS[1], 12, eos_token=eos)[1][-1].finish_reason == \
            pair[0].generate(PROMPTS[1], 12, eos_token=eos)[1][-1].finish_reason == "eos"
    finally:
        for s in pair:
            s.close()


def _status(served, case):
    """(code, details) the client sees for one failure case."""
    eng, stub = served.eng, served.stub
    if case == "queue_full":
        held = [eng.submit([1], max_new=80)]
        assert wait_for(lambda: eng.active_slots == 1)
        held.append(eng.submit([2], max_new=80))
    elif case == "draining":
        eng.stop(drain=True, timeout=30)
    if case == "cancel":
        call = stub.Generate(pb.GenerateRequest(prompt=[5], max_new_tokens=80), timeout=60)
        next(call)  # the stream is live and holds the slot
        call.cancel()
        with pytest.raises(grpc.RpcError) as err:
            list(call)
        assert wait_for(lambda: eng.active_slots == 0)
    else:
        prompt = [] if case == "invalid" else [3]
        with pytest.raises(grpc.RpcError) as err:
            list(stub.Generate(pb.GenerateRequest(prompt=prompt, max_new_tokens=2),
                               timeout=60))
    if case == "queue_full":
        for h in held:
            h.cancel()
            h.result(timeout=60)
        assert wait_for(lambda: eng.active_slots == 0 and eng.queue_len == 0)
    return err.value.code(), err.value.details()


@pytest.mark.parametrize("case", ["queue_full", "draining", "cancel", "invalid"])
def test_status_codes_equal_jax(model, case):
    pair = [Served(m, e) for m, e in zip((jservice, tservice),
                                         engines(model, max_batch=1, queue_depth=1))]
    try:
        jcode, tcode = (_status(s, case) for s in pair)
        assert tcode == jcode
        assert tcode[0] == {"queue_full": grpc.StatusCode.RESOURCE_EXHAUSTED,
                            "draining": grpc.StatusCode.UNAVAILABLE,
                            "cancel": grpc.StatusCode.CANCELLED,
                            "invalid": grpc.StatusCode.INVALID_ARGUMENT}[case]
    finally:
        for s in pair:
            s.close()


@pytest.mark.parametrize("kw", [{}, {"prefix_cache_bytes": 0, "kv_page_tokens": 8},
                                {"spec_tokens": 3}])
def test_capabilities_and_identity_equal_jax(model, kw):
    jp, tp, jcfg, tcfg = model
    if kw.get("spec_tokens"):
        kw = {**kw}
        jk = dict(kw, draft_params=jp, draft_cfg=jcfg)
        tk = dict(kw, draft_params=tp, draft_cfg=tcfg)
    else:
        jk = tk = kw
    pair = [Served(jservice, JServeEngine(jp, jcfg, **ENGINE, **jk)),
            Served(tservice, TServeEngine(tp, tcfg, device="cpu", **ENGINE, **tk))]
    try:
        caps = [m.serve_capabilities(s.eng) for m, s in zip((jservice, tservice), pair)]
        assert caps[1] == caps[0]
        infos = [IdentityStub(s.channel).GetInfo(pb.GetInfoRequest(), timeout=10) for s in pair]
        assert list(infos[1].capabilities) == list(infos[0].capabilities) == sorted(caps[0])
        assert infos[1].name == infos[0].name == "oim-serve"
        probes = [IdentityStub(s.channel).Probe(pb.ProbeRequest(), timeout=10) for s in pair]
        assert probes[1].ready and probes[0].ready
        for s in pair:
            s.eng.stop(drain=True, timeout=30)
        probes = [IdentityStub(s.channel).Probe(pb.ProbeRequest(), timeout=10) for s in pair]
        assert not probes[1].ready and not probes[0].ready
    finally:
        for s in pair:
            s.close()


# ------------------------------------------------------------ weights ----


def _blob_tree(jp, pad: int, n: int) -> dict:
    """JAX's params with the matrices in bf16 and a replicated leaf whose
    name pads the manifest, which moves the offset the leaves start at.
    bf16 leaves are handed to JAX's ``pack_params`` as numpy's raw 2-byte
    view of them ("void16"), which it names bfloat16."""
    import ml_dtypes

    def bf16(a):
        return a.astype(ml_dtypes.bfloat16).view("V2")

    tree = jax.tree.map(np.asarray, jp)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][name] = bf16(tree["layers"][name])
    tree["embed"] = bf16(tree["embed"])
    tree["p" * pad] = np.arange(n, dtype=np.float32)
    return tree


def _base(tree) -> int:
    blob = jweights.pack_params(tree)
    return 16 + int.from_bytes(blob[8:16], "little")


@pytest.fixture(scope="module")
def blob(model, tmp_path_factory):
    """(path, JAX tree): a packed file whose leaves start at an odd offset,
    so every leaf but a uint8 one is misaligned, and one at a multiple of
    4, so every leaf is aligned."""
    jp = model[0]
    d = tmp_path_factory.mktemp("weights")
    out = {}
    for pad, n in ((pad, n) for pad in range(1, 5) for n in (6, 16, 106, 1006)):
        tree = _blob_tree(jp, pad, n)
        kind = {1: "odd", 3: "odd", 0: "aligned"}.get(_base(tree) % 4)
        if kind and kind not in out:
            path = str(d / f"{kind}.oimw")
            jweights.save_packed(tree, path)
            out[kind] = (path, tree)
    assert set(out) == {"odd", "aligned"}
    return out


def _bytes_tree(tree, prefix="") -> dict:
    """path -> (dtype name, shape, bytes) of a numpy or torch tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_bytes_tree(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype).split(".")[-1]
        return {prefix[:-1]: (name, tuple(t.shape), t.reshape(-1).view(torch.uint8)
                              .numpy().tobytes())}
    a = np.ascontiguousarray(tree)
    name = "bfloat16" if a.dtype.name in ("void16", "bfloat16") else a.dtype.name
    return {prefix[:-1]: (name, a.shape, a.tobytes())}


def _local_feeders(path):
    j = JFeeder(controller=JControllerService(JMallocBackend()))
    t = TFeeder(controller=tcontroller.ControllerService(CUDABackend(device="cpu")))
    jweights.publish_weights(j, "weights", path)
    tweights.publish_weights(t, "weights", path)
    return j, t


@pytest.mark.parametrize("kind", ["odd", "aligned"])
@pytest.mark.parametrize("shard,rank", [(1, 0), (2, 0), (2, 1)])
def test_local_restore_equals_jax_bitwise(blob, kind, shard, rank):
    path, _ = blob[kind]
    j, t = _local_feeders(path)
    want = jweights.restore_weights(j, "weights", shard=shard, rank=rank)
    jlast = dict(jweights.LAST_RESTORE)
    got = tweights.restore_weights(t, "weights", shard=shard, rank=rank)
    assert _bytes_tree(got) == _bytes_tree(want)
    assert tweights.LAST_RESTORE == jlast
    assert all(v.device.type == "cpu" for v in _leaves(got))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("kind", ["odd", "aligned"])
def test_restore_views_aligned_leaves_and_copies_the_others(blob, kind):
    """A leaf whose offset in the blob its element size divides is a view
    of the staged volume; ``Tensor.view(dtype)`` refuses the others, which
    are copied. A member's split leaves are compact copies either way."""
    path, tree = blob[kind]
    _, t = _local_feeders(path)
    array = t.controller.get_volume("weights").array
    lo, hi = array.data_ptr(), array.data_ptr() + array.numel()
    got = dict(zip(_bytes_tree(tree), _leaves(tweights.restore_weights(t, "weights"))))
    header, base = tweights._header(array)
    for leaf in header["leaves"]:
        name = ".".join(leaf["path"][2:-2].split("']['"))
        inside = lo <= got[name].data_ptr() < hi
        assert inside == ((base + leaf["offset"]) % got[name].element_size() == 0), name
    member = dict(zip(_bytes_tree(tree), _leaves(
        tweights.restore_weights(t, "weights", shard=2, rank=1))))
    assert not lo <= member["layers.wq"].data_ptr() < hi


def test_restore_refuses_what_jax_refuses(blob, tmp_path):
    path, _ = blob["odd"]
    j, t = _local_feeders(path)
    for feeder, mod in ((j, jweights), (t, tweights)):
        with pytest.raises(ValueError, match="outside shard=2"):
            mod.restore_weights(feeder, "weights", shard=2, rank=2)
        with pytest.raises(ValueError, match="no volume 'nope'"):
            mod.restore_weights(feeder, "nope")
    bad = tmp_path / "bad.oimw"
    bad.write_bytes(b"NOTOIMW0" + bytes(64))
    for mod in (jweights, tweights):
        feeder = (JFeeder(controller=JControllerService(JMallocBackend())) if mod is jweights
                  else TFeeder(controller=tcontroller.ControllerService(
                      CUDABackend(device="cpu"))))
        mod.publish_weights(feeder, "bad", str(bad))
        with pytest.raises(ValueError, match="bad magic"):
            mod.restore_weights(feeder, "bad")
    odd = blob["odd"][1]
    with pytest.raises(ValueError, match="does not divide by shard=3"):
        tweights.restore_from_array(np.frombuffer(jweights.pack_params(odd), np.uint8),
                                    shard=3, rank=0)


def test_weights_request_and_pack_equal_jax(model, blob, tmp_path):
    path, tree = blob["odd"]
    size = os.path.getsize(path)
    assert tweights.weights_request("w", path, size).SerializeToString(deterministic=True) == \
        jweights.weights_request("w", path, size).SerializeToString(deterministic=True)
    _, tp, _, _ = model
    jp = jax.tree.map(np.asarray, model[0])
    assert tweights.save_packed(tp, str(tmp_path / "t.oimw")) == \
        jweights.save_packed(jp, str(tmp_path / "j.oimw"))
    assert (tmp_path / "t.oimw").read_bytes() == (tmp_path / "j.oimw").read_bytes()


def quick_watch(service):
    service.watch.keepalive = 0.02
    return service


class Plane:
    """JAX's registry with port controller daemons (``CUDABackend(device=
    "cpu")``) registered at one coordinate."""

    def __init__(self, n=1):
        self.service = quick_watch(RegistryService(db=MemRegistryDB()))
        self.registry = registry_server("tcp://localhost:0", self.service)
        self.addr = self.registry.addr
        self.channel = jtlsutil.dial(self.addr, None)
        self.stub = RegistryStub(self.channel)
        self.controllers, self.servers = [], []
        for i in range(n):
            c = tcontroller.Controller(
                controller_id=f"host-{i}", backend=CUDABackend(device="cpu"),
                controller_address="pending", registry_address=self.addr,
                registry_delay=0.1, mesh_coord=MeshCoord.parse("1,2,3"))
            server = tcontroller.controller_server("tcp://localhost:0", c.service)
            c.controller_address = server.addr
            c.start()
            self.controllers.append(c)
            self.servers.append(server)
        assert wait_for(lambda: len([v for v in self.rows("") if v.path.endswith("/address")])
                        == n)

    def rows(self, path, stale=False):
        return self.stub.GetValues(pb.GetValuesRequest(path=path, include_stale=stale),
                                   timeout=10).values

    def close(self):
        for c, s in zip(self.controllers, self.servers):
            c.stop()
            s.stop()
        self.channel.close()
        wait_for(lambda: not self.service.watch._streams, 5)
        self.registry.stop()


@pytest.fixture
def plane():
    p = Plane(n=2)
    yield p
    p.close()


@pytest.mark.parametrize("shard,rank", [(1, 0), (2, 0), (2, 1)])
def test_remote_restore_equals_jax_bitwise(blob, plane, shard, rank):
    """Published once through the registry's proxy to a port controller;
    JAX's Feeder and the port's each read one whole-volume window."""
    path, tree = blob["odd"]
    feeders = [JFeeder(registry_address=plane.addr, controller_id="host-0"),
               TFeeder(registry_address=plane.addr, controller_id="host-0")]
    try:
        tweights.publish_weights(feeders[1], "weights", path)
        jweights.publish_weights(feeders[0], "weights", path)
        want = jweights.restore_weights(feeders[0], "weights", shard=shard, rank=rank)
        jlast = dict(jweights.LAST_RESTORE)
        got = tweights.restore_weights(feeders[1], "weights", shard=shard, rank=rank)
        assert _bytes_tree(got) == _bytes_tree(want)
        assert tweights.LAST_RESTORE == jlast
        if shard == 1:
            assert _bytes_tree(got) == _bytes_tree(tree)
    finally:
        for f in feeders:
            f.close()


# ------------------------------------------------------ rows and router ----


def _same_state(pair, model):
    """Drive both engines through the same requests, one at a time, with a
    host tier: a shared 32-token prefix retires into the prefix store,
    which is then demoted to host RAM, then a fresh prefix stays hot."""
    prefix = list(range(3, 35))
    for eng in pair:
        for tail in ([40, 41], [42]):
            h = eng.submit(prefix + tail, max_new=6)
            h.result(timeout=120)
        eng.evict_prefix_store()  # the engine is idle: demote the chains
        eng.submit(list(range(50, 70)), max_new=4).result(timeout=120)


@pytest.fixture
def tiered(model):
    pair = engines(model, prefix_block=16, kv_host_bytes=1 << 20)
    _same_state(pair, model)
    yield pair
    for eng in pair:
        eng.stop(drain=False, timeout=30)


def test_advertisement_equals_jax(tiered):
    jeng, teng = tiered
    assert teng.hot_prefixes() == jeng.hot_prefixes()
    assert teng.hot_prefixes(1) == jeng.hot_prefixes(1)
    assert teng.prefix_tiers() == jeng.prefix_tiers()
    assert set(teng.prefix_tiers().values()) == {"hbm", "host"}
    assert teng.prefix_tiers(1) == jeng.prefix_tiers(1)
    assert teng.exported_volumes() == jeng.exported_volumes() == {}


def test_serve_row_equals_jax(tiered, plane):
    jeng, teng = tiered
    snaps = [jreg.load_snapshot("h:1", jeng), treg.load_snapshot("h:1", teng)]
    assert snaps[1] == snaps[0]
    assert {"prefix_hashes", "prefix_tiers", "prefix_block"} <= set(snaps[1])
    assert "prefix_volumes" not in snaps[1]
    regs = [mod.ServeRegistration(sid, "h:1", eng, plane.addr, interval=0.1, version="v2")
            for mod, sid, eng in ((jreg, "j0", jeng), (treg, "t0", teng))]
    try:
        for r in regs:
            r.beat_once()
        rows = {v.path: v.value for v in plane.rows("serve")}
        assert json.loads(rows["serve/t0"]) == json.loads(rows["serve/j0"])
        assert rows["serve/t0"] == rows["serve/j0"]
        assert json.loads(rows["serve/t0"])["version"] == "v2"
        for r in regs:
            r.announce_draining()
        rows = {v.path: json.loads(v.value) for v in plane.rows("serve")}
        assert rows["serve/t0"] == rows["serve/j0"] and rows["serve/t0"]["ready"] is False
    finally:
        for r in regs:
            r.stop(deregister=True)
    assert not plane.rows("serve", stale=True)


def test_member_rows_equal_jax(plane):
    members = [mod.ShardMembers(sid, 2, plane.addr, interval=0.1)
               for mod, sid in ((jshard, "j0"), (tmembers, "t0"))]
    try:
        for m in members:
            m.start()
        rows = {v.path: v.value for v in plane.rows("serve")}
        for k in (0, 1):
            assert rows[tmembers.member_key("t0", k)] == rows[jshard.member_key("j0", k)]
        assert tmembers.member_key("t0", 1) == "serve/t0.member.1"
        assert members[1].member_counts() == members[0].member_counts() == \
            {"ready": 2, "stale": 0, "total": 2}
        for m in members:
            m.stop_member(1)
        assert wait_for(lambda: all(m.member_counts()["ready"] == 1 for m in members), 5)
        assert members[1].member_counts() == members[0].member_counts() == \
            {"ready": 1, "stale": 1, "total": 2}
    finally:
        for m in members:
            m.stop(deregister=True)


def test_jax_router_routes_to_a_port_replica(model, plane):
    _, teng = engines(model)
    served = Served(tservice, teng)
    reg = treg.ServeRegistration("t0", served.server.addr, teng, plane.addr, interval=0.1)
    table = ReplicaTable(plane.addr, interval=0.1)
    table.start()
    router = router_server("tcp://127.0.0.1:0", RouterService(table))
    channel = jtlsutil.dial(router.addr, None)
    try:
        reg.start()
        assert wait_for(lambda: len(table) == 1)
        direct, _ = served.generate(PROMPTS[1], 10)
        deltas = list(ServeStub(channel).Generate(
            pb.GenerateRequest(prompt=PROMPTS[1], max_new_tokens=10), timeout=120))
        assert [t for d in deltas for t in d.tokens] == direct
        assert deltas[-1].finish_reason == "length"
    finally:
        channel.close()
        router.stop()
        table.stop()
        reg.stop(deregister=True)
        served.close()


# ----------------------------------------------------------------- CLI ----


class Daemon:
    """``oim_serve.main(argv)`` in this (the main) thread, with a client
    thread that waits for its socket, streams ``check`` and then sends the
    process SIGTERM; the previous SIGTERM handler comes back after."""

    def __init__(self, sock, check):
        self.sock, self.check, self.out, self.error = sock, check, {}, None
        self.prev = signal.getsignal(signal.SIGTERM)
        self.done = threading.Event()  # main returned: signal nothing

    def _client(self):
        try:
            assert wait_for(lambda: os.path.exists(self.sock) or self.done.is_set(), 60)
            if self.done.is_set():
                return
            with grpc.insecure_channel(f"unix://{self.sock}") as ch:
                # The socket file appears at bind, before the server listens.
                grpc.channel_ready_future(ch).result(timeout=60)
                self.check(ServeStub(ch), self.out)
        except BaseException as e:  # noqa: BLE001 - reported by run()
            self.error = e
        finally:
            # Only to this daemon's own handler: the test process's would end
            # the run, and a later test's daemon is not this one.
            installed = wait_for(lambda: self.done.is_set()
                                 or signal.getsignal(signal.SIGTERM) is not self.prev, 30)
            if installed and not self.done.is_set():
                os.kill(os.getpid(), signal.SIGTERM)

    def run(self, argv):
        prev = self.prev
        thread = threading.Thread(target=self._client, daemon=True)
        thread.start()
        try:
            rc = tcli.main(argv + ["--endpoint", f"unix://{self.sock}", "--device", "cpu",
                                   "--log-level", "error", "--max-batch", "2",
                                   "--max-seq", "64"])
        finally:
            self.done.set()
            signal.signal(signal.SIGTERM, prev)
            tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
        thread.join(30)
        if self.error is not None:
            raise self.error
        return rc


def _stream(stub, out, prompt=(1, 2, 3), n=5):
    deltas = list(stub.Generate(pb.GenerateRequest(prompt=list(prompt), max_new_tokens=n),
                                timeout=60))
    out["tokens"] = [t for d in deltas for t in d.tokens]
    out["reason"] = deltas[-1].finish_reason


def _solo(params, cfg, prompt=(1, 2, 3), n=5):
    eng = TServeEngine(params, cfg, device="cpu", max_batch=2, max_seq=64)
    try:
        return eng.submit(list(prompt), max_new=n).result(timeout=60)
    finally:
        eng.stop(drain=False)


@pytest.fixture(scope="module")
def packed(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "w.oimw")
    tweights.save_packed(model[1], path)
    return path


def test_main_serves_a_weights_file_locally_and_drains(model, packed, tmp_path):
    rc = (d := Daemon(str(tmp_path / "s.sock"), _stream)).run(
        ["--weights-file", packed, "--backend", "cuda"])
    assert rc == 0
    assert d.out == {"tokens": _solo(model[1], model[3]), "reason": "length"}


def test_main_serves_a_checkpoint_and_packs_it(model, tmp_path, monkeypatch):
    from oim_tpu_torch.cli import oim_trainer

    ckpt = str(tmp_path / "ckpt")
    assert oim_trainer.main(["--model", "llama-tiny", "--steps", "1", "--batch-size", "2",
                             "--seq-len", "16", "--device", "cpu", "--log-level", "error",
                             "--checkpoint-dir", ckpt, "--checkpoint-every", "1"]) == 0
    pack = str(tmp_path / "packed.oimw")
    d = Daemon(str(tmp_path / "s.sock"), _stream)
    assert d.run(["--checkpoint-dir", ckpt, "--pack-to", pack]) == 0
    tree = tweights.unpack_params(open(pack, "rb").read(), device="cpu")
    assert d.out == {"tokens": _solo(tree, model[3]), "reason": "length"}


def test_main_remote_registers_prestages_and_deregisters(model, packed, plane, tmp_path,
                                                         monkeypatch):
    """--registry + --controller-id, --prestage, --serve-id, --shard 2:
    the member leases land before the serve row's first beat, the row
    carries the version, and the drain runs in JAX's order."""
    order = []
    for owner, name, attr in ((treg.ServeRegistration, "announce", "announce_draining"),
                              (TServeEngine, "engine.stop", "stop"),
                              (treg.ServeRegistration, "registration.stop", "stop"),
                              (tmembers.ShardMembers, "members.stop", "stop")):
        real = getattr(owner, attr)
        monkeypatch.setattr(owner, attr, lambda self, *a, _r=real, _n=name, **k: (
            order.append(_n), _r(self, *a, **k))[1])
    seen = {}

    def check(stub, out):
        assert wait_for(lambda: any(v.path == "serve/r0" for v in plane.rows("serve")), 30)
        rows = {v.path: json.loads(v.value) for v in plane.rows("serve")}
        seen.update(rows)
        _stream(stub, out)

    d = Daemon(str(tmp_path / "s.sock"), check)
    assert d.run(["--weights-file", packed, "--registry", plane.addr, "--controller-id",
                  "host-0", "--prestage", "host-1", "--serve-id", "r0", "--heartbeat", "0.2",
                  "--shard", "2", "--weights-version", "v7",
                  "--advertise", "127.0.0.1:1"]) == 0
    assert order == ["announce", "engine.stop", "registration.stop", "members.stop"]
    assert d.out["tokens"] == _solo(model[1], model[3])
    row = seen["serve/r0"]
    assert (row["endpoint"], row["version"], row["shard_total"], row["shard_ready"],
            row["ready"]) == ("127.0.0.1:1", "v7", 2, 2, True)
    assert seen["serve/r0.member.0"] == seen["serve/r0.member.1"] | {"member": 0}
    assert not plane.rows("serve", stale=True)
    # --prestage warmed host-1's stage cache with the same content.
    assert plane.controllers[1].service.backend.cache.stats()["entries"] >= 1


def test_main_restore_only_serves_the_mapped_volume(model, packed, plane, tmp_path):
    feeder = TFeeder(registry_address=plane.addr, controller_id="host-0")
    try:
        tweights.publish_weights(feeder, "weights", packed)
    finally:
        feeder.close()
    d = Daemon(str(tmp_path / "s.sock"), _stream)
    assert d.run(["--restore-only", "--registry", plane.addr, "--controller-id",
                  "host-0"]) == 0
    assert d.out["tokens"] == _solo(model[1], model[3])


def test_main_speculates_from_a_draft_file(model, packed, tmp_path):
    d = Daemon(str(tmp_path / "s.sock"), _stream)
    assert d.run(["--weights-file", packed, "--backend", "malloc", "--spec-tokens", "3",
                  "--draft-weights-file", packed]) == 0
    assert d.out["tokens"] == _solo(model[1], model[3])


JAX_REFUSALS = [
    [],
    ["--weights-file", "w", "--restore-only"],
    ["--restore-only", "--spec-tokens", "2"],
    ["--restore-only", "--draft-weights-file", "d"],
    ["--restore-only", "--backend", "malloc", "--spec-tokens", "1", "--draft-restore-only"],
    ["--restore-only", "--backend", "malloc", "--prestage", "host-1"],
    ["--restore-only", "--serve-id", "r0"],
    ["--checkpoint-dir", "c", "--kv-peer-fetch"],
    ["--checkpoint-dir", "c", "--role", "prefill"],
]


@pytest.mark.parametrize("argv", JAX_REFUSALS)
def test_refusals_carry_the_jax_cli_messages(argv):
    msgs = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as err:
            main(argv + ["--log-level", "error"])
        msgs.append(str(err.value))
    tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    assert msgs[1] == msgs[0] and msgs[0]


def test_weights_without_a_control_plane_and_a_wildcard_are_refused(packed, plane,
                                                                     tmp_path):
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit, match="need --backend"):
            main(["--weights-file", packed, "--log-level", "error"])
    # A daemon that did not refuse would serve until the client's SIGTERM.
    with pytest.raises(SystemExit, match="would advertise the wildcard address"):
        Daemon(str(tmp_path / "s.sock"), lambda stub, out: None).run(
            ["--weights-file", packed, "--backend", "malloc", "--registry", plane.addr,
             "--serve-id", "r0", "--advertise", "0.0.0.0:9002"])
    with pytest.raises(SystemExit, match="refusing to serve random init"):
        tcli.main(["--checkpoint-dir", "/nonexistent/ckpt", "--device", "cpu",
                   "--log-level", "error"])
    with pytest.raises(SystemExit, match="refusing to speculate from random init"):
        tcli.main(["--weights-file", packed, "--backend", "malloc", "--device", "cpu",
                   "--spec-tokens", "2", "--draft-checkpoint-dir", "/nonexistent/draft",
                   "--log-level", "error"])
    tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    assert not plane.rows("serve", stale=True)


def test_cli_flags_are_jax_ones_but_the_device():
    """Every flag of the JAX CLI is the port's, but --platform, which is
    the port's --device; --backend names cuda for tpu."""
    import argparse

    def flags(module):
        parser = argparse.ArgumentParser()
        captured = []
        real = argparse.ArgumentParser.add_argument

        def add(self, *a, **k):
            captured.extend(x for x in a if x.startswith("--"))
            return real(self, *a, **k)

        argparse.ArgumentParser.add_argument = add
        try:
            with pytest.raises(SystemExit):
                module.main(["--help"]) if module is jcli else module.parse_args(["--help"])
        finally:
            argparse.ArgumentParser.add_argument = real
        del parser
        return set(captured)

    jflags, tflags = flags(jcli), flags(tcli)
    assert tflags - jflags == {"--device"}
    assert jflags - tflags == {"--platform"}


def test_daemon_and_restore_modules_load_no_grpc_or_protobuf():
    """The card machine has neither: the CLI module and the weights module
    (the restore's grpc-free core) import without them."""
    import subprocess
    import sys

    code = ("import sys; import oim_tpu_torch.cli.oim_serve, oim_tpu_torch.serve.weights; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('grpc', 'jax', "
            "'oim_tpu') or m.startswith('google.protobuf')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
