"""Sharded placement in the port's data plane (``plane.Placement``,
``plane.Placed``, ``slice_runs``, ``placement_bytes``, the concurrent
shard groups of ``stage_source``), ``CUDABackend(mesh=...)`` and the
trainer's device-resident feed, held against the JAX package on the CPU in
one process, on the same seeded bytes.

JAX stages under a NamedSharding over the 8 fake CPU devices of
tests/conftest.py laid out as data=4, model=2 (tests/test_plane.py's
``mesh8``); the port stages under a placement over a ``plane.LocalMesh``
of eight "cpu" devices in the same row-major order, or over one rank's
view of a port ``Mesh`` (``Mesh(axes, ranks, "cpu", rank=r)``, no process
group: each rank reads and lands its own slice). Bytes are copied, never
converted: every comparison is exact.
"""

import io
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from oim_tpu.controller.backend import StagedVolume as JStagedVolume
from oim_tpu.controller.tpu_backend import TPUBackend
from oim_tpu.data import plane as jplane
from oim_tpu.spec import pb
from oim_tpu_torch import spec as tspec
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.common.meshcoord import UNSET
from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
from oim_tpu_torch.controller.cuda_backend import device_mesh_coord
from oim_tpu_torch.data import plane as tplane
from oim_tpu_torch.data import readers as treaders
from oim_tpu_torch.parallel.mesh import Mesh
from oim_tpu_torch.train import trainer as ttrainer
from tests.test_torch_sources import _auth, _Gateway, _params, _token_shard

AXES8 = [("data", 4), ("model", 2)]


@pytest.fixture(scope="module")
def mesh8():
    return JMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))


@pytest.fixture(scope="module")
def local8():
    return tplane.LocalMesh(AXES8, ["cpu"] * 8)


@pytest.fixture
def gateway():
    server = _Gateway()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _coord(mesh8, device) -> tuple:
    return tuple(int(c) for c in np.argwhere(mesh8.devices == device)[0])


def _jax_shards(mesh8, arr) -> dict:
    return {_coord(mesh8, s.device): np.asarray(s.data).tobytes()
            for s in arr.addressable_shards}


def _port_shards(placed) -> dict:
    return {coord: _bytes_of(t) for coord, _, t in placed.shards}


def _stage(backend, kind, params, spec, volume_id="vol"):
    vol = StagedVolume(volume_id, b"", spec)
    backend.stage(vol, kind, params)
    assert vol.wait(60)
    assert vol.state == StageState.READY, vol.error
    return vol


def _jax_stage(backend, kind, params, spec):
    vol = JStagedVolume("vol", b"", spec)
    backend.stage(vol, kind, params)
    assert vol.wait(60) and not vol.error, vol.error
    return vol


# ------------------------------------------------------- placement lowering --


def _random_index(rng, shape):
    index = []
    for n in shape:
        r = rng.rand()
        if r < 0.3:
            index.append(slice(None))
        else:
            a = rng.randint(0, n)
            b = rng.randint(a + 1, n + 1)
            index.append(slice(a, b, 2 if r > 0.93 else None))
    return tuple(index)


@pytest.mark.parametrize("seed", range(40))
def test_slice_runs_matches_jax(seed):
    """Random shapes, slices and item sizes, stepped slices among them:
    the same runs (or None) as the JAX package's."""
    rng = np.random.RandomState(seed)
    shape = tuple(int(n) for n in rng.randint(1, 7, rng.randint(0, 5)))
    index = _random_index(rng, shape)
    itemsize = int(rng.choice([1, 2, 4, 8]))
    got = tplane.slice_runs(shape, index, itemsize)
    assert got == jplane.slice_runs(shape, index, itemsize)
    if got is not None:
        runs, slice_shape = got
        host = np.arange(int(np.prod(shape)) * itemsize, dtype=np.uint8)
        want = host.view(f"V{itemsize}").reshape(shape)[index].tobytes()
        assert b"".join(host[o:o + n].tobytes() for o, n in runs) == want
        assert slice_shape == tuple(len(range(*s.indices(n))) for s, n in zip(index, shape))


@pytest.mark.parametrize("n_batches,want_runs", [(tplane.MAX_RUNS, tplane.MAX_RUNS),
                                                 (tplane.MAX_RUNS + 1, None)])
def test_slice_runs_at_the_max_runs_edge(n_batches, want_runs):
    """A token volume [N, 2, T+1] with its batch dim split in two: each
    rank's slice is N runs of T+1 tokens, lowerable up to MAX_RUNS runs
    and falling back past it, in both packages."""
    shape, index = (n_batches, 2, 2049), (slice(None), slice(1, 2), slice(None))
    got = tplane.slice_runs(shape, index, 4)
    assert (got is None) == (jplane.slice_runs(shape, index, 4) is None)
    if want_runs is None:
        assert got is None
        return
    runs, slice_shape = got
    assert len(runs) == want_runs and slice_shape == (n_batches, 1, 2049)
    assert runs[:2] == jplane.slice_runs(shape, index, 4)[0][:2] == [(8196, 8196),
                                                                     (3 * 8196, 8196)]


SPECS = [("data", "model"), ("", "model"), ("data", ""), ("", ""), (("data", "model"), ""),
         (("model", "data"), "")]


def _jspec(spec):
    return P(*[e or None for e in spec])


@pytest.mark.parametrize("spec", SPECS)
def test_indices_map_and_placement_bytes_match_jax(mesh8, local8, spec):
    shape = (16, 6)
    placement = tplane.Placement.of(local8, spec)
    sharding = NamedSharding(mesh8, _jspec(spec))
    want = {_coord(mesh8, d): idx
            for d, idx in sharding.addressable_devices_indices_map(shape).items()}
    assert placement.addressable_indices_map(shape) == want
    for dtype, np_dtype in ((torch.uint8, np.uint8), (torch.int32, np.int32),
                            (torch.float64, np.float64)):
        assert tplane.placement_bytes(shape, dtype, placement) == jplane.placement_bytes(
            shape, np_dtype, sharding)


def test_placement_refuses_what_a_named_sharding_refuses(local8):
    with pytest.raises(ValueError, match="Resource axis: seq"):
        tplane.Placement.of(local8, ("seq", ""))
    with pytest.raises(ValueError, match="once"):
        tplane.Placement.of(local8, ("data", "data"))
    with pytest.raises(ValueError, match="partitioned 4 times, but the dimension size is 10"):
        tplane.Placement.of(local8, ("data",)).addressable_indices_map((10, 4))
    with pytest.raises(ValueError, match="need 8 devices, got 4"):
        tplane.LocalMesh(AXES8, ["cpu"] * 4)


# ------------------------------------------------- the backend against JAX --


def _tfrecord_volume(tmp_path):
    """Three TFRecord files whose bytes add up to a multiple of 64."""
    rng = np.random.default_rng(3)
    records = [rng.bytes(int(k)) for k in rng.integers(1, 900, 11)]
    total = sum(16 + len(r) for r in records)
    records.append(rng.bytes((-(total + 16)) % 64 + 64))
    paths = []
    for i, part in enumerate((records[:4], records[4:9], records[9:])):
        path = tmp_path / f"train-{i:05d}-of-00003.tfrecord"
        treaders.write_tfrecords(path, part)
        paths.append(str(path))
    return paths


@pytest.fixture
def sources(tmp_path, gateway):
    """One volume of each source kind, each a multiple of 64 bytes."""
    raw = tmp_path / "vol.bin"
    raw.write_bytes(np.random.default_rng(1).bytes(4096))
    npy = tmp_path / "tok.npy"
    np.save(npy, np.random.default_rng(2).integers(0, 1 << 20, (16, 6), dtype=np.int32))
    shards = [_token_shard(s, 3 + s)[0] for s in range(2)]
    local = []
    for i, d in enumerate(shards):
        p = tmp_path / f"shard-{i}.tar"
        p.write_bytes(d)
        local.append(str(p))
    urls = [gateway.put(f"/wds/shard-{i}.tar", d, f'"s{i}"') for i, d in enumerate(shards)]
    image = np.random.default_rng(5).bytes(300_032)
    gateway.put("/rbd/vol-7", image, '"img"')
    gateway.auth["/rbd/vol-7"] = _auth("alice", "s3cret")
    return {
        "raw": ("file", dict(path=str(raw), format="raw")),
        "npy": ("file", dict(path=str(npy), format="npy")),
        "tfrecord": ("tfrecord", dict(paths=_tfrecord_volume(tmp_path))),
        "webdataset-local": ("webdataset", dict(shard_urls=local)),
        "webdataset-url": ("webdataset", dict(shard_urls=urls)),
        "ceph": ("ceph", dict(monitors=gateway.url, user="alice", secret="s3cret",
                              pool="rbd", image="vol-7")),
    }


def _specs(kind, axes):
    """(JAX ArraySpec, port ArraySpec): a .npy keeps its own dtype and
    shape, the other sources are bytes viewed as 8 rows."""
    if kind == "npy":
        return pb.ArraySpec(sharding_axes=list(axes)), tspec.ArraySpec(sharding_axes=axes)
    return (pb.ArraySpec(shape=[8, -1], dtype="uint8", sharding_axes=list(axes)),
            tspec.ArraySpec((8, -1), "uint8", axes))


KINDS = ["raw", "npy", "tfrecord", "webdataset-local", "webdataset-url", "ceph"]


@pytest.mark.parametrize("axes", [("data", ""), ("", "model")], ids=["data", "replicated"])
@pytest.mark.parametrize("kind", KINDS)
def test_backend_shards_equal_jax_shards(sources, mesh8, local8, kind, axes):
    """Each addressable shard staged by ``CUDABackend(mesh=...)`` equals
    the matching shard of ``TPUBackend(mesh=mesh8)``'s array byte for
    byte, over the plane (one stage_source call), with the placement's
    bytes as the volume's total."""
    params_kind, fields = sources[kind]
    jparams, tparams = _params(params_kind, **fields)
    jspec, tspec_ = _specs(kind, axes)
    want = _jax_stage(TPUBackend(mesh=mesh8, chunk_bytes=700), params_kind, jparams, jspec)
    calls = tplane.STAGE_CALLS
    vol = _stage(CUDABackend(device="cpu", mesh=local8, chunk_bytes=700), params_kind,
                 tparams, tspec_)
    assert tplane.STAGE_CALLS == calls + 1
    placed = vol.array
    assert isinstance(placed, tplane.Placed)
    assert placed.shape == want.array.shape and len(placed.shards) == 8
    assert _port_shards(placed) == _jax_shards(mesh8, want.array)
    assert vol.total_bytes == placed.nbytes == jplane.placement_bytes(
        want.array.shape, want.array.dtype, want.array.sharding)
    assert _bytes_of(placed.assemble()) == np.asarray(want.array).tobytes()


@pytest.mark.parametrize("kind", ["raw", "npy", "tfrecord"])
def test_run_explosion_takes_the_whole_read_path_in_both(sources, mesh8, local8, monkeypatch,
                                                        kind):
    """Past MAX_RUNS runs a slice is not lowered: both backends fall back to
    the whole read, and the port places every addressable slice of the
    host array as ``jax.device_put(host, sharding)`` does."""
    monkeypatch.setattr(jplane, "MAX_RUNS", 2)
    monkeypatch.setattr(tplane, "MAX_RUNS", 2)
    params_kind, fields = sources[kind]
    jparams, tparams = _params(params_kind, **fields)
    jspec, tspec_ = _specs(kind, ("", "model"))
    want = _jax_stage(TPUBackend(mesh=mesh8), params_kind, jparams, jspec)
    refs = []
    orig = tplane._device_empty

    def tracked(nbytes, device):
        buf = orig(nbytes, device)
        refs.append(buf)
        return buf

    monkeypatch.setattr(tplane, "_device_empty", tracked)
    calls = tplane.STAGE_CALLS
    vol = _stage(CUDABackend(device="cpu", mesh=local8), params_kind, tparams, tspec_)
    assert tplane.STAGE_CALLS == calls + 1 and not refs  # lowered first, nothing allocated
    assert _port_shards(vol.array) == _jax_shards(mesh8, want.array)


def test_sharded_spec_without_a_mesh_fails_with_jax_message(sources):
    jparams, tparams = _params("file", **sources["raw"][1])
    jvol = JStagedVolume("v", b"", pb.ArraySpec(shape=[8, -1], dtype="uint8",
                                                sharding_axes=["data", ""]))
    TPUBackend().stage(jvol, "file", jparams)
    assert jvol.wait(60)
    vol = StagedVolume("v", b"", tspec.ArraySpec((8, -1), "uint8", ("data", "")))
    CUDABackend(device="cpu").stage(vol, "file", tparams)
    assert vol.wait(60)
    assert vol.state == StageState.FAILED
    assert vol.error == jvol.error


@pytest.mark.parametrize("rank", range(4))
def test_each_rank_of_a_mesh_stages_its_own_slice(tmp_path, rank):
    """A rank's view of a port Mesh holds one device: it reads and lands
    its own slice only (a quarter of the bytes), equal to the JAX shard of
    that coordinate. A token volume [N, B, T+1] split on B gives each rank
    its rows of every batch: batch i is ``local[i]``."""
    vol_np = np.random.default_rng(7).integers(0, 50_000, (5, 4, 9), dtype=np.int32)
    path = tmp_path / "tokens.npy"
    np.save(path, vol_np)
    jmesh = JMesh(np.array(jax.devices()[:4]), ("data",))
    want = _jax_stage(TPUBackend(mesh=jmesh), "file", pb.FileParams(path=str(path),
                                                                    format="npy"),
                      pb.ArraySpec(sharding_axes=["", "data", ""]))
    mesh = Mesh([("data", 4)], range(4), "cpu", rank=rank)
    reads = []
    orig = tplane.READERS["file"]

    def recording(locator, offset, length, dst, headers):
        reads.append(length)
        orig(locator, offset, length, dst, headers)

    tplane.READERS["file"] = recording
    try:
        vol = _stage(CUDABackend(device="cpu", mesh=mesh), "file",
                     tspec.FileParams(str(path), "npy"), tspec.ArraySpec(
                         sharding_axes=("", "data", "")))
    finally:
        tplane.READERS["file"] = orig
    placed = vol.array
    assert [c for c, _, _ in placed.shards] == [(rank,)]
    assert sum(reads) == vol_np.nbytes // 4 == placed.nbytes == vol.total_bytes
    assert _port_shards(placed) == {(rank,): _jax_shards(jmesh, want.array)[(rank,)]}
    for i in range(vol_np.shape[0]):
        np.testing.assert_array_equal(placed[i].local.numpy(), vol_np[i, rank:rank + 1])
        assert placed[i].shape == (4, 9)
    with pytest.raises(ValueError, match="do not cover"):
        placed.assemble()


# -------------------------------------------------- concurrency and cancel --


def _slow_source(tmp_path, monkeypatch, nbytes, delay=0.02):
    data = np.random.default_rng(9).bytes(nbytes)
    path = tmp_path / "slow.bin"
    path.write_bytes(data)

    def slow_read(locator, offset, length, dst, headers):
        time.sleep(delay)
        tplane.READERS["file"](locator, offset, length, dst, headers)

    monkeypatch.setitem(tplane.READERS, "slow", slow_read)
    return data, tplane.ExtentSource([tplane.Extent("slow", str(path), 0, nbytes)])


def test_serial_and_concurrent_groups_stage_the_same_bytes(tmp_path, monkeypatch, local8):
    """max_workers=1 (the serial path) and 8 land the same shards, equal to
    JAX's; the concurrent run has more than one group in flight."""
    data, src = _slow_source(tmp_path, monkeypatch, 64 * 64)
    placement = tplane.Placement.of(local8, ("data", None))
    serial = tplane.stage_source(src, dtype=torch.float32, shape=(64, 16),
                                 placement=placement, chunk_bytes=600, max_workers=1)
    assert tplane.LAST_STAGE_CONCURRENCY == 1
    parallel = tplane.stage_source(src, dtype=torch.float32, shape=(64, 16),
                                   placement=placement, chunk_bytes=600, max_workers=8)
    assert tplane.LAST_STAGE_CONCURRENCY > 1
    assert _port_shards(serial) == _port_shards(parallel)
    assert _bytes_of(parallel.assemble()) == data
    # 4 distinct slices, each landed on its 2 holders: the peak is the 8 shards
    assert tplane.LAST_STAGE_PEAK == 2 * len(data) == parallel.nbytes
    assert set(tplane.LAST_STAGE_BREAKDOWN) == {"disk_s", "h2d_s", "dispatch_s"}


def test_cancel_mid_stage_frees_every_group(tmp_path, monkeypatch, local8):
    """progress returning False while groups are in flight: stage_source
    returns None and no destination of any group survives."""
    _, src = _slow_source(tmp_path, monkeypatch, 1 << 16, delay=0.01)
    refs = []
    orig = tplane._device_empty

    def tracked(nbytes, device):
        buf = orig(nbytes, device)
        refs.append(weakref.ref(buf))
        return buf

    monkeypatch.setattr(tplane, "_device_empty", tracked)
    seen = []
    out = tplane.stage_source(src, dtype=torch.uint8, shape=(1 << 16,),
                              placement=tplane.Placement.of(local8, ("data",)),
                              chunk_bytes=2048, max_workers=4,
                              progress=lambda d: seen.append(d) or len(seen) < 6)
    assert out is None and tplane.LAST_STAGE_CONCURRENCY > 1
    assert seen == sorted(seen)
    assert len(refs) == 8 and all(r() is None for r in refs)
    assert not [t for t in threading.enumerate() if t.name == "oim-plane-fill"]


def test_unstage_during_a_sharded_stage_fails_the_volume(tmp_path, monkeypatch, local8):
    _, src = _slow_source(tmp_path, monkeypatch, 1 << 15, delay=0.02)
    monkeypatch.setattr(tplane, "lower_source", lambda kind, params: src)
    backend = CUDABackend(device="cpu", mesh=local8, chunk_bytes=1024, keep_cached=False)
    vol = StagedVolume("v", b"", tspec.ArraySpec((1 << 15,), "uint8", ("data",)))
    backend.stage(vol, "file", tspec.FileParams(src.extents[0].locator))
    deadline = time.monotonic() + 10
    while vol.bytes_staged == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    backend.unstage(vol)
    assert vol.wait(30) and vol.state == StageState.FAILED
    assert "unmapped during staging" in vol.error


# ---------------------------------------------------- cache and coordinates --


def test_cache_key_is_pinned_to_the_mesh(sources, local8):
    jparams, tparams = _params("file", **sources["raw"][1])
    del jparams
    backend = CUDABackend(device="cpu", mesh=local8)
    spec = tspec.ArraySpec((8, -1), "uint8", ("data", ""))
    first = _stage(backend, "file", tparams, spec)
    calls = tplane.STAGE_CALLS
    again = _stage(backend, "file", tparams, spec, volume_id="again")
    assert tplane.STAGE_CALLS == calls and again.array is first.array  # a hit
    _stage(backend, "file", tparams, tspec.ArraySpec((8, -1), "uint8", ("", "model")))
    assert tplane.STAGE_CALLS == calls + 1  # another spec: a miss
    sig = backend._placement_sig(spec)
    assert sig == ("mesh", tuple(AXES8), ("devices", ("cpu",) * 8), ("data", ""))
    other = CUDABackend(device="cpu", mesh=tplane.LocalMesh([("data", 2), ("model", 4)],
                                                             ["cpu"] * 8))
    assert other._placement_sig(spec) != sig
    rank = CUDABackend(device="cpu", mesh=Mesh([("data", 4)], range(4), "cpu", rank=2))
    assert rank._placement_sig(spec) == ("mesh", (("data", 4),), ("ranks", (0, 1, 2, 3)),
                                         ("data", ""))
    assert backend._placement_sig(tspec.ArraySpec((8, -1), "uint8")) == ("device",)


def test_coord_of_matches_jax(sources, mesh8, local8):
    """A CPU device (and a CUDA card) has no interconnect coordinate: every
    component UNSET, as the JAX package gives off a TPU."""
    jparams, tparams = _params("file", **sources["raw"][1])
    jb, tb = TPUBackend(mesh=mesh8), CUDABackend(device="cpu", mesh=local8)
    for jspec, tspec_ in (_specs("raw", ("data", "")), _specs("raw", ("", ""))):
        jvol = _jax_stage(jb, "file", jparams, jspec)
        tvol = _stage(tb, "file", tparams, tspec_)
        j, t = jb.coord_of(jvol), tb.coord_of(tvol)
        assert (t.x, t.y, t.z, t.core) == (j.x, j.y, j.z, j.core) == (UNSET,) * 4
        assert tvol.device_id == jvol.device_id == 0
    assert device_mesh_coord(torch.device("cpu")).format() == "*,*,*"


# ----------------------------------------------------- the trainer's feed --


def _log_capture():
    buf = io.StringIO()
    return buf, tlogging.set_global(tlogging.Logger(buf, level=tlogging.WARNING))


@pytest.mark.parametrize("rank", range(2))
def test_place_batch_passes_a_matching_placed_batch_untouched(tmp_path, rank):
    """Rank ``rank`` of a dp trainer over data=2 (its view of the mesh, no
    process group): a batch staged with ["", "data", ""] through
    ``CUDABackend(mesh=trainer.mesh)`` comes back as the rank's own tensor
    (no copy), with the rows place_batch cuts from the host batch."""
    vol_np = np.random.default_rng(11).integers(0, 256, (3, 2, 17), dtype=np.int32)
    path = tmp_path / "tokens.npy"
    np.save(path, vol_np)
    mesh = Mesh([("data", 2)], [0, 1], "cpu", rank=rank)
    tr = ttrainer.Trainer(ttrainer.TrainConfig(batch_size=2, seq_len=16), device="cpu",
                          mesh=mesh)
    vol = _stage(CUDABackend(device="cpu", mesh=mesh), "file",
                 tspec.FileParams(str(path), "npy"),
                 tspec.ArraySpec(sharding_axes=("", "data", "")))
    buf, prev = _log_capture()
    try:
        for i in range(3):
            placed = vol.array[i]
            out = tr.place_batch({"tokens": placed})["tokens"]
            assert out.data_ptr() == placed.local.data_ptr()
            np.testing.assert_array_equal(
                out.numpy(), tr.place_batch({"tokens": vol_np[i]})["tokens"].numpy())
    finally:
        tlogging.set_global(prev)
    assert "mismatch" not in buf.getvalue()


def test_place_batch_warns_once_then_recuts_a_mismatched_placed_batch(tmp_path):
    """A batch placed otherwise than the step's cut (its sequence dim
    split over data, on a one-rank mesh; a LocalMesh's placement whose
    shards cover the array) is warned about once per key, then gathered
    and cut as a host batch would be, every step."""
    vol_np = np.random.default_rng(12).integers(0, 256, (3, 2, 16), dtype=np.int32)
    path = tmp_path / "tokens.npy"
    np.save(path, vol_np)
    mesh = Mesh([("data", 1)], [0], "cpu")
    tr = ttrainer.Trainer(ttrainer.TrainConfig(batch_size=2, seq_len=15), device="cpu",
                          mesh=mesh)
    by_seq = _stage(CUDABackend(device="cpu", mesh=mesh), "file",
                    tspec.FileParams(str(path), "npy"),
                    tspec.ArraySpec(sharding_axes=("", "", "data"))).array
    local = _stage(CUDABackend(device="cpu", mesh=tplane.LocalMesh([("data", 2)],
                                                                   ["cpu"] * 2)),
                   "file", tspec.FileParams(str(path), "npy"),
                   tspec.ArraySpec(sharding_axes=("", "data", "")), volume_id="l").array
    buf, prev = _log_capture()
    try:
        for i in range(3):
            for key, placed in (("a", by_seq[i]), ("b", local[i])):
                out = tr.place_batch({key: placed})[key]
                np.testing.assert_array_equal(out.numpy(), vol_np[i])
    finally:
        tlogging.set_global(prev)
    lines = [ln for ln in buf.getvalue().splitlines() if "sharding mismatch" in ln]
    assert len(lines) == 2 and "'a'" in lines[0] and "'b'" in lines[1]


@pytest.mark.parametrize("rank", range(2))
def test_place_batch_recuts_a_placed_batch_under_accumulation(tmp_path, monkeypatch, rank):
    """A batch placed as the step's cut, but stepped with accum_steps=2 over
    data=2: a rank's contiguous rows are not its rows of each accumulation
    microbatch, so the leaf is gathered and cut as a host batch would be,
    under a warning that names the accumulation, not a mismatch."""
    vol_np = np.random.default_rng(13).integers(0, 256, (2, 4, 17), dtype=np.int32)
    path = tmp_path / "tokens.npy"
    np.save(path, vol_np)
    mesh = Mesh([("data", 2)], [0, 1], "cpu", rank=rank)
    tr = ttrainer.Trainer(ttrainer.TrainConfig(batch_size=4, seq_len=16, accum_steps=2),
                          device="cpu", mesh=mesh)
    vol = _stage(CUDABackend(device="cpu", mesh=mesh), "file",
                 tspec.FileParams(str(path), "npy"),
                 tspec.ArraySpec(sharding_axes=("", "data", "")))
    gathered = []
    # One process holds one rank's view: the gather over data stands in for
    # the other rank's rows with the file's.
    monkeypatch.setattr(ttrainer, "_gathered", lambda v, m: gathered.append(v) or
                        torch.from_numpy(vol_np[len(gathered) - 1]))
    buf, prev = _log_capture()
    try:
        for i in range(2):
            placed = vol.array[i]
            out = tr.place_batch({"tokens": placed})["tokens"]
            np.testing.assert_array_equal(placed.local.numpy(), vol_np[i, 2 * rank:2 * rank + 2])
            np.testing.assert_array_equal(out.numpy(), vol_np[i, rank::2])
            np.testing.assert_array_equal(
                out.numpy(), tr.place_batch({"tokens": vol_np[i]})["tokens"].numpy())
    finally:
        tlogging.set_global(prev)
    assert [g.shape for g in gathered] == [(4, 17)] * 2
    lines = buf.getvalue().splitlines()
    assert not [ln for ln in lines if "mismatch" in ln]
    warned = [ln for ln in lines if "not by microbatch" in ln]
    assert len(warned) == 1 and "accum_steps" in warned[0]


@pytest.mark.parametrize("workers,concurrent", [(1, False), (8, True)])
def test_stage_workers_sets_the_group_pool_width(tmp_path, monkeypatch, local8, workers,
                                                  concurrent):
    """``CUDABackend(stage_workers=...)`` is the width of the shard-group
    pool: 1 stages the groups one after another, 8 has several in flight;
    both land the file's bytes."""
    data, src = _slow_source(tmp_path, monkeypatch, 1 << 13, delay=0.01)
    monkeypatch.setattr(tplane, "lower_source", lambda kind, params: src)
    monkeypatch.setenv("OIM_STAGE_WORKERS", "2")
    backend = CUDABackend(device="cpu", mesh=local8, chunk_bytes=512, stage_workers=workers)
    vol = _stage(backend, "file", tspec.FileParams(src.extents[0].locator),
                 tspec.ArraySpec((1 << 13,), "uint8", ("data",)))
    assert (tplane.LAST_STAGE_CONCURRENCY > 1) == concurrent
    assert tplane.LAST_STAGE_CONCURRENCY <= workers
    assert _bytes_of(vol.array.assemble()) == data
