"""The port's feeder daemon (``oim_tpu_torch/feeder/service.py``,
``cli/oim_feeder.py``) held against the JAX package's over the wire.

Each package's ``FeederDaemon`` is served by its own ``feeder_server``
over its own Feeder, and one client asks both the same questions:
PublishVolume (a map, an emulation, and the refused requests, by status
code), ReadPublished (windows, the chunk sizes asked for and capped, the
first chunk's spec and total), ListPublished, UnpublishVolume and
Identity's capabilities. Local mode runs an in-process controller;
remote mode goes through JAX's registry to each package's controller.
The CLI runs as a local malloc daemon in a subprocess and refuses JAX's
mode mixes.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import time

import grpc
import numpy as np
import pytest

from oim_tpu.controller import controller as jcontroller
from oim_tpu.controller.malloc_backend import MallocBackend as JMallocBackend
from oim_tpu.feeder import driver as jdriver
from oim_tpu.feeder import service as jservice
from oim_tpu.spec import pb
from oim_tpu_torch.cli import oim_feeder as tcli
from oim_tpu_torch.common.tlsutil import dial
from oim_tpu_torch.controller import CUDABackend, MallocBackend
from oim_tpu_torch.controller import controller as tcontroller
from oim_tpu_torch.feeder import driver as tdriver
from oim_tpu_torch.feeder import service as tservice
from oim_tpu_torch.spec.services import FeederStub, IdentityStub
from tests.test_torch_feeder_train import remote

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """A float32 .npy of 4.5 MiB: more than one default chunk."""
    d = tmp_path_factory.mktemp("daemon")
    vals = np.random.default_rng(3).standard_normal((1152, 1024)).astype(np.float32)
    path = d / "vol.npy"
    np.save(path, vals)
    return vals, str(path)


@contextlib.contextmanager
def served(service_mod, feeder):
    server = service_mod.feeder_server("tcp://localhost:0",
                                       service_mod.FeederDaemon(feeder, default_timeout=30))
    ch = dial(server.addr, None)
    try:
        yield FeederStub(ch), IdentityStub(ch)
    finally:
        ch.close()
        server.force_stop()
        feeder.close()


@contextlib.contextmanager
def local_daemons(tbackend=None):
    with served(jservice, jdriver.Feeder(
            controller=jcontroller.ControllerService(JMallocBackend()))) as j, \
            served(tservice, tdriver.Feeder(controller=tcontroller.ControllerService(
                tbackend if tbackend is not None else MallocBackend()))) as t:
        yield j, t


def call(fn, req):
    """A unary reply, or the status code it failed with."""
    try:
        return fn(req, timeout=30)
    except grpc.RpcError as e:
        return e.code()


def stream(fn, req):
    try:
        return [(c.data, c.offset, c.total_bytes, c.spec.SerializeToString(deterministic=True))
                for c in fn(req, timeout=30)]
    except grpc.RpcError as e:
        return e.code()


def publish_file(path, vid="v"):
    return pb.PublishVolumeRequest(map=pb.MapVolumeRequest(
        volume_id=vid, file=pb.FileParams(path=path, format="npy")))


def test_publish_read_list_unpublish_match_jax(volume):
    vals, path = volume
    with local_daemons() as ((jf, _), (tf, _)):
        replies = [call(s.PublishVolume, publish_file(path)) for s in (jf, tf)]
        assert replies[0] == replies[1] and replies[1].placement.bytes == vals.nbytes
        for req in (pb.ReadVolumeRequest(volume_id="v"),
                    pb.ReadVolumeRequest(volume_id="v", offset=1000, length=5 << 20),
                    pb.ReadVolumeRequest(volume_id="v", offset=77, length=100_000,
                                         chunk_bytes=7001),
                    pb.ReadVolumeRequest(volume_id="v", chunk_bytes=64 << 20),
                    pb.ReadVolumeRequest(volume_id="v", offset=vals.nbytes),
                    pb.ReadVolumeRequest(volume_id="nope")):
            got, want = stream(tf.ReadPublished, req), stream(jf.ReadPublished, req)
            assert got == want, req
        chunks = stream(tf.ReadPublished, pb.ReadVolumeRequest(volume_id="v"))
        assert b"".join(c[0] for c in chunks) == vals.tobytes()
        assert {len(c[0]) for c in chunks[:-1]} == {tservice.READ_CHUNK}
        big = stream(tf.ReadPublished, pb.ReadVolumeRequest(volume_id="v",
                                                            chunk_bytes=64 << 20))
        assert len(big[0][0]) == min(tservice.MAX_READ_CHUNK, vals.nbytes)
        assert stream(tf.ReadPublished, pb.ReadVolumeRequest(volume_id="nope")) == \
            grpc.StatusCode.NOT_FOUND
        lists = [call(s.ListPublished, pb.ListPublishedRequest()) for s in (jf, tf)]
        assert lists[0] == lists[1] and len(lists[1].published) == 1
        for s in (jf, tf):
            assert call(s.UnpublishVolume, pb.UnpublishVolumeRequest(volume_id="v")) == \
                pb.UnpublishVolumeReply()
            assert call(s.UnpublishVolume, pb.UnpublishVolumeRequest(volume_id="v")) == \
                pb.UnpublishVolumeReply()
        assert stream(tf.ReadPublished, pb.ReadVolumeRequest(volume_id="v")) == \
            stream(jf.ReadPublished, pb.ReadVolumeRequest(volume_id="v"))
        assert [len(call(s.ListPublished, pb.ListPublishedRequest()).published)
                for s in (jf, tf)] == [0, 0]


@pytest.mark.parametrize("req", [
    pb.PublishVolumeRequest(volume_id="x"),
    pb.PublishVolumeRequest(emulate="nope", volume_id="x"),
    pb.PublishVolumeRequest(emulate="ceph-csi", volume_id="x", attributes={"pool": "p"}),
    pb.PublishVolumeRequest(map=pb.MapVolumeRequest(
        volume_id="x", file=pb.FileParams(path="/no/such/file.npy", format="npy"))),
], ids=["neither", "unknown-emulation", "bad-attributes", "missing-file"])
def test_refused_publishes_give_jax_codes(req):
    with local_daemons() as ((jf, _), (tf, _)):
        want = call(jf.PublishVolume, req)
        assert isinstance(want, grpc.StatusCode)
        assert call(tf.PublishVolume, req) == want


def test_emulated_publish_matches_jax(tmp_path):
    from oim_tpu.data import readers as jreaders

    path = tmp_path / "a.tfrecord"
    jreaders.write_tfrecords(path, [b"x" * 37, b"y" * 91])
    req = pb.PublishVolumeRequest(emulate="tfrecord", volume_id="tf",
                                  attributes={"paths": str(path)})
    with local_daemons() as ((jf, _), (tf, _)):
        assert call(tf.PublishVolume, req) == call(jf.PublishVolume, req)
        r = pb.ReadVolumeRequest(volume_id="tf")
        assert stream(tf.ReadPublished, r) == stream(jf.ReadPublished, r)


@pytest.mark.parametrize("backend", ["malloc", "cuda"])
def test_capabilities_match_jax(backend):
    tbackend = MallocBackend() if backend == "malloc" else CUDABackend(device="cpu")
    with local_daemons(tbackend) as ((_, ji), (_, ti)):
        want = call(ji.GetInfo, pb.GetInfoRequest())
        got = call(ti.GetInfo, pb.GetInfoRequest())
    assert got.name == want.name == "oim-feeder"
    if backend == "malloc":
        assert list(got.capabilities) == list(want.capabilities)
    else:
        assert list(got.capabilities) == sorted(c.replace("backend:malloc", "backend:cuda")
                                                for c in want.capabilities)
    assert "mode:local" in got.capabilities


def test_remote_mode_through_the_registry_matches_jax(volume):
    vals, path = volume
    with remote(jcontroller, JMallocBackend()) as (jaddr, _), \
            remote(tcontroller, MallocBackend()) as (taddr, tcs):
        with served(jservice, jdriver.Feeder(registry_address=jaddr,
                                             controller_id="host-0")) as (jf, ji), \
                served(tservice, tdriver.Feeder(registry_address=taddr,
                                                controller_id="host-0")) as (tf, ti):
            replies = [call(s.PublishVolume, publish_file(path)) for s in (jf, tf)]
            assert replies[0] == replies[1]
            assert tcs.get_volume("v") is not None
            for req in (pb.ReadVolumeRequest(volume_id="v", offset=5, length=3 << 20,
                                             chunk_bytes=1 << 20),
                        pb.ReadVolumeRequest(volume_id="v")):
                got = stream(tf.ReadPublished, req)
                assert got == stream(jf.ReadPublished, req)
            assert b"".join(c[0] for c in got) == vals.tobytes()
            caps = [list(call(i.GetInfo, pb.GetInfoRequest()).capabilities) for i in (ji, ti)]
            assert caps[0] == caps[1] and "mode:remote" in caps[1]
            for s in (jf, tf):
                call(s.UnpublishVolume, pb.UnpublishVolumeRequest(volume_id="v"))


@pytest.mark.parametrize("argv", [
    [],
    ["--backend", "malloc", "--registry", "127.0.0.1:1", "--controller-id", "h"],
    ["--backend", "malloc", "--warm-standby"],
    ["--registry", "127.0.0.1:1", "--controller-id", "h", "--window-chunk-bytes", "-1"],
], ids=["no-mode", "both-modes", "local-warm-standby", "negative-chunk"])
def test_cli_refusals(argv):
    with pytest.raises(SystemExit):
        tcli.parse_args(argv)


def test_local_malloc_cli_serves(volume):
    vals, path = volume
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "oim_tpu_torch.cli.oim_feeder", "--endpoint",
         f"tcp://127.0.0.1:{port}", "--backend", "malloc", "--log-level", "error"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ch = None
    try:
        # A fresh channel each try: a channel that failed to connect backs
        # off for longer each time, past a slow start on a loaded machine.
        info, deadline = None, time.monotonic() + 120
        while info is None and time.monotonic() < deadline and proc.poll() is None:
            ch = dial(f"127.0.0.1:{port}", None)
            try:
                info = IdentityStub(ch).GetInfo(pb.GetInfoRequest(), timeout=2,
                                                wait_for_ready=True)
            except grpc.RpcError:
                ch.close()
                ch = None
                time.sleep(0.2)
        assert info is not None, proc.communicate(timeout=10)[0] if proc.poll() is not None \
            else "no answer"
        assert list(info.capabilities) == sorted(jservice.feeder_capabilities(
            jdriver.Feeder(controller=jcontroller.ControllerService(JMallocBackend()))))
        stub = FeederStub(ch)
        assert stub.PublishVolume(publish_file(path), timeout=30).placement.bytes == \
            vals.nbytes
        data = b"".join(c.data for c in stub.ReadPublished(
            pb.ReadVolumeRequest(volume_id="v", offset=8, length=4096), timeout=30))
        assert data == vals.tobytes()[8:4104]
    finally:
        if ch is not None:
            ch.close()
        proc.terminate()
        proc.wait(timeout=30)
