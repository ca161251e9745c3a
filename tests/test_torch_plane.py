"""The port's data plane (oim_tpu_torch.data: plane, staging, readers) held
against the JAX package's on the CPU, in one process: source lowering
field for field, range and view reads across extent boundaries, run
shape resolution with its errors, the chunk stream, and
the bytes ``stage_source`` lands for each dtype, which must equal JAX's
exactly (bytes are copied, never converted: the tolerance is zero).

JAX stages into a CPU device array through its SingleDeviceSharding path;
the port stages into a CPU tensor through the same pipeline it runs on a
CUDA device, less the pinned slots and the copy stream.
"""

import threading
import weakref

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import SingleDeviceSharding

from oim_tpu.data import plane as jplane
from oim_tpu.spec import pb
from oim_tpu_torch import spec as tspec
from oim_tpu_torch.controller.backend import spec_dtype as tspec_dtype
from oim_tpu_torch.data import plane as tplane
from oim_tpu_torch.data import readers as treaders
from oim_tpu_torch.data import staging as tstaging

CPU = jax.devices("cpu")[0]


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.fixture
def files(tmp_path):
    """Three raw files (one empty), a C-order and a Fortran-order .npy."""
    rs = np.random.RandomState(0)
    out = {}
    for name, n in (("a.bin", 1000), ("empty.bin", 0), ("b.bin", 2500)):
        p = tmp_path / name
        p.write_bytes(rs.bytes(n))
        out[name] = str(p)
    arr = rs.randint(0, 1 << 20, (37, 11)).astype(np.int32)
    np.save(tmp_path / "c.npy", arr)
    np.save(tmp_path / "f.npy", np.asfortranarray(arr))
    out["c.npy"], out["f.npy"] = str(tmp_path / "c.npy"), str(tmp_path / "f.npy")
    out["arr"] = arr
    return out


def _params(kind, files):
    """(JAX params message, port params dataclass) of one source case."""
    if kind == "raw":
        return "file", pb.FileParams(path=files["b.bin"], format="raw"), \
            tspec.FileParams(files["b.bin"], "raw")
    if kind == "default-format":
        return "file", pb.FileParams(path=files["a.bin"]), tspec.FileParams(files["a.bin"])
    if kind in ("npy", "fortran-npy"):
        p = files["c.npy" if kind == "npy" else "f.npy"]
        return "file", pb.FileParams(path=p, format="npy"), tspec.FileParams(p, "npy")
    if kind == "unknown-format":
        return "file", pb.FileParams(path=files["a.bin"], format="csv"), \
            tspec.FileParams(files["a.bin"], "csv")
    paths = [files["a.bin"], files["empty.bin"], files["b.bin"]]
    if kind == "tfrecord":
        return "tfrecord", pb.TFRecordParams(paths=paths), tspec.TFRecordParams(tuple(paths))
    assert kind == "webdataset"
    return "webdataset", pb.WebDatasetParams(shard_urls=paths), \
        tspec.WebDatasetParams(tuple(paths))


def _fields(src):
    if src is None:
        return None
    return ([(e.kind, e.locator, e.offset, e.length, e.object_size) for e in src.extents],
            src.headers, src.src_dtype, src.src_shape, src.total_bytes, src._starts)


@pytest.mark.parametrize("kind", ["raw", "default-format", "npy", "fortran-npy",
                                  "unknown-format", "tfrecord", "webdataset"])
def test_lower_source_matches_jax_field_for_field(files, kind):
    pkind, jparams, tparams = _params(kind, files)
    want = _fields(jplane.lower_source(pkind, jparams))
    got = _fields(tplane.lower_source(pkind, tparams))
    assert got == want
    assert (got is None) == (kind in ("fortran-npy", "unknown-format"))


def test_lower_source_missing_file_raises_like_jax(tmp_path):
    missing = str(tmp_path / "nope.bin")
    with pytest.raises(FileNotFoundError):
        jplane.lower_source("file", pb.FileParams(path=missing, format="raw"))
    with pytest.raises(FileNotFoundError):
        tplane.lower_source("file", tspec.FileParams(missing, "raw"))


@pytest.mark.parametrize("kind,params", [
    ("webdataset", tspec.WebDatasetParams(("http://127.0.0.1:9/shard-0.tar",))),
    ("ceph", None),
])
def test_unported_sources_raise_not_implemented(kind, params):
    """Both kinds are ported: lowering a shard URL that nothing serves (a
    closed loopback port) and ceph without params raise as in JAX."""
    from oim_tpu.data import objectstore as jobjectstore
    from oim_tpu_torch.data import objectstore as tobjectstore

    jparams = None if params is None else pb.WebDatasetParams(shard_urls=list(params.shard_urls))
    want = AttributeError if params is None else jobjectstore.ObjectStoreError
    got = AttributeError if params is None else tobjectstore.ObjectStoreError
    with pytest.raises(want):
        jplane.lower_source(kind, jparams)
    with pytest.raises(got, match=None if params is None else "127.0.0.1:9"):
        tplane.lower_source(kind, params)


@pytest.mark.parametrize("off,n", [(0, 1000), (990, 20), (0, 3500), (1500, 2000), (3499, 1)])
def test_read_range_across_extents_matches_jax(files, off, n):
    _, jparams, tparams = _params("tfrecord", files)
    jsrc = jplane.lower_source("tfrecord", jparams)
    tsrc = tplane.lower_source("tfrecord", tparams)
    want = np.zeros(n, np.uint8)
    got = np.zeros(n, np.uint8)
    jplane.read_range(jsrc, off, want)
    tplane.read_range(tsrc, off, got)
    np.testing.assert_array_equal(got, want)
    with open(files["a.bin"], "rb") as fa, open(files["b.bin"], "rb") as fb:
        whole = fa.read() + fb.read()
    assert got.tobytes() == whole[off:off + n]


def test_read_range_outside_the_volume_raises(files):
    tsrc = tplane.lower_source("file", tspec.FileParams(files["a.bin"]))
    with pytest.raises(ValueError, match="outside volume"):
        tplane.read_range(tsrc, 990, np.zeros(20, np.uint8))


def test_read_view_over_runs_matches_jax(files):
    _, jparams, tparams = _params("tfrecord", files)
    jsrc = jplane.lower_source("tfrecord", jparams)
    tsrc = tplane.lower_source("tfrecord", tparams)
    runs = [(3000, 400), (100, 950), (0, 50)]
    starts = [0, 400, 1350]
    for off, n in ((0, 1400), (390, 20), (1340, 60)):
        want, got = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
        jplane.read_view(jsrc, runs, starts, off, want)
        tplane.read_view(tsrc, runs, starts, off, got)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,n", [
    (None, 12), ((), 12), ((3, 4), 12), ((-1, 4), 12), ((2, -1, 3), 12),
    ((5, 4), 12), ((-1, 5), 12), ((0, -1), 12), ((-1,), 0), ((3, 0), 0),
])
def test_resolve_shape_matches_jax(shape, n):
    try:
        want = jplane.resolve_shape(shape, n)
    except ValueError:
        with pytest.raises(ValueError, match="cannot reshape"):
            tplane.resolve_shape(shape, n)
        return
    assert tplane.resolve_shape(shape, n) == want


@pytest.mark.parametrize("chunk,pad_tail", [(700, False), (700, True), (1024, True),
                                            (5000, True)])
def test_iter_view_chunks_matches_jax(files, chunk, pad_tail):
    _, jparams, tparams = _params("tfrecord", files)
    runs = [(0, 3500)]
    want = [(o, bytes(c)) for o, c in jplane.iter_view_chunks(
        jplane.lower_source("tfrecord", jparams), runs, chunk, pad_tail=pad_tail)]
    got = [(o, bytes(c)) for o, c in tplane.iter_view_chunks(
        tplane.lower_source("tfrecord", tparams), runs, chunk, pad_tail=pad_tail)]
    assert got == want
    if pad_tail:
        assert {len(c) for _, c in got} == {min(chunk, 3500)}
    out = bytearray(3500)
    for o, c in got:
        out[o:o + len(c)] = c
    with open(files["a.bin"], "rb") as fa, open(files["b.bin"], "rb") as fb:
        assert bytes(out) == fa.read() + fb.read()


def test_iter_view_chunks_reader_error_reaches_the_consumer(files, monkeypatch):
    calls = []

    def broken(locator, offset, length, dst, headers):
        calls.append(offset)
        if len(calls) == 3:
            raise OSError("disk gone")
        dst[:length] = 7

    monkeypatch.setitem(tplane.READERS, "file", broken)
    src = tplane.lower_source("file", tspec.FileParams(files["b.bin"]))
    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for off, _ in tplane.iter_view_chunks(src, [(0, 2500)], 500):
            seen.append(off)
    assert seen == [0, 500]


def _write_volume(tmp_path, np_dtype, n, seed=1):
    rs = np.random.RandomState(seed)
    raw = rs.bytes(n * np.dtype(np_dtype).itemsize)
    path = tmp_path / "vol.bin"
    path.write_bytes(raw)
    return str(path), raw


def _both_staged(path, dtype_name, shape, chunk):
    src_j = jplane.lower_source("file", pb.FileParams(path=path, format="raw"))
    src_t = tplane.lower_source("file", tspec.FileParams(path, "raw"))
    jdt = ml_dtypes.bfloat16 if dtype_name == "bfloat16" else np.dtype(dtype_name)
    jarr = jplane.stage_source(src_j, dtype=jdt, shape=shape,
                               sharding=SingleDeviceSharding(CPU), chunk_bytes=chunk)
    tarr = tplane.stage_source(src_t, dtype=tspec_dtype(tspec.ArraySpec(dtype=dtype_name)),
                               shape=shape, device="cpu", chunk_bytes=chunk)
    return np.asarray(jarr), tarr


@pytest.mark.parametrize("dtype_name", ["uint8", "int32", "float32", "bfloat16", "float16"])
def test_stage_source_bytes_equal_jax(tmp_path, dtype_name):
    itemsize = 2 if dtype_name == "bfloat16" else np.dtype(dtype_name).itemsize
    n = 6 * 1000 // itemsize
    path, raw = _write_volume(tmp_path, np.uint8, 6 * 1000)
    shape = (6, n // 6)
    jarr, tarr = _both_staged(path, dtype_name, shape, chunk=1000 + 24)
    assert tuple(tarr.shape) == shape == jarr.shape
    assert str(tarr.dtype).removeprefix("torch.") == dtype_name
    assert _bytes_of(tarr) == jarr.tobytes() == raw
    if dtype_name == "bfloat16":  # the same bits, read as uint16
        np.testing.assert_array_equal(tarr.view(torch.int16).numpy().view(np.uint16),
                                      jarr.view(np.uint16))


@pytest.mark.parametrize("n_bytes,chunk", [(10_000, 3_000), (10_000, 1 << 20), (0, 4096),
                                           (4096, 4096)])
def test_stage_source_odd_chunk_sizes(tmp_path, n_bytes, chunk):
    path, raw = _write_volume(tmp_path, np.uint8, n_bytes)
    jarr, tarr = _both_staged(path, "uint8", (n_bytes,), chunk)
    assert _bytes_of(tarr) == jarr.tobytes() == raw
    assert tplane.LAST_STAGE_PEAK == n_bytes  # chunks land in place
    assert set(tplane.LAST_STAGE_BREAKDOWN) == {"disk_s", "h2d_s", "dispatch_s"}


@pytest.mark.parametrize("n_bytes,chunk", [(10_000, 3_000), (10_000, 2_500), (10_000, 9_999),
                                           (10_000, 1 << 20), (1, 4096)])
def test_stage_source_reads_each_byte_once(tmp_path, monkeypatch, n_bytes, chunk):
    """A short last chunk is copied as it is: the staging path reads no
    byte twice (the JAX package's padded tail would re-read up to a chunk)."""
    path, raw = _write_volume(tmp_path, np.uint8, n_bytes)
    orig = tplane.READERS["file"]
    ranges = []

    def recording(locator, offset, length, dst, headers):
        ranges.append((offset, length))
        orig(locator, offset, length, dst, headers)

    monkeypatch.setitem(tplane.READERS, "file", recording)
    src = tplane.lower_source("file", tspec.FileParams(path))
    arr = tplane.stage_source(src, dtype=torch.uint8, shape=(n_bytes,), device="cpu",
                              chunk_bytes=chunk)
    assert _bytes_of(arr) == raw
    assert sorted(ranges) == [(o, min(chunk, n_bytes - o)) for o in range(0, n_bytes, chunk)]


def test_stage_source_progress_is_monotone_and_reaches_the_total(tmp_path):
    path, raw = _write_volume(tmp_path, np.uint8, 10_000)
    src = tplane.lower_source("file", tspec.FileParams(path))
    seen = []
    arr = tplane.stage_source(src, dtype=torch.uint8, shape=(10_000,), device="cpu",
                              chunk_bytes=3_000, progress=lambda d: seen.append(d) or True)
    assert _bytes_of(arr) == raw
    assert seen == sorted(seen) and seen[-1] == 10_000 and len(seen) == 4


def test_stage_source_abort_returns_none_and_drops_the_destination(tmp_path, monkeypatch):
    path, _ = _write_volume(tmp_path, np.uint8, 10_000)
    src = tplane.lower_source("file", tspec.FileParams(path))
    refs = []
    orig = tplane._device_empty

    def tracked(nbytes, device):
        buf = orig(nbytes, device)
        refs.append(weakref.ref(buf))
        return buf

    monkeypatch.setattr(tplane, "_device_empty", tracked)
    before = tplane.STAGE_CALLS
    out = tplane.stage_source(src, dtype=torch.uint8, shape=(10_000,), device="cpu",
                              chunk_bytes=1_000, progress=lambda d: d < 3_000)
    assert out is None and tplane.STAGE_CALLS == before + 1
    assert len(refs) == 1 and refs[0]() is None
    assert not [t for t in threading.enumerate() if t.name == "oim-plane-fill"]


def test_stage_source_keeps_64_bit_bytes(tmp_path):
    """torch has float64 and int64, so the port stages their bytes
    unchanged; JAX with x64 off sends such sources through value
    conversion to 32 bits (its TPUBackend's whole-read path)."""
    for np_dtype, name in ((np.float64, "float64"), (np.int64, "int64")):
        arr = np.random.RandomState(2).randn(300).astype(np_dtype)
        path = tmp_path / f"{name}.npy"
        np.save(path, arr)
        src = tplane.lower_source("file", tspec.FileParams(str(path), "npy"))
        out = tplane.stage_source(src, dtype=getattr(torch, name), shape=(300,),
                                  device="cpu", chunk_bytes=1000)
        assert out.dtype == getattr(torch, name)
        assert _bytes_of(out) == arr.tobytes()
        assert not jax.config.jax_enable_x64
        assert jax.numpy.asarray(arr).dtype.itemsize == 4


def test_read_into_parallel_and_short_file(tmp_path):
    data = np.random.RandomState(3).bytes((9 << 20) + 123)
    path = tmp_path / "big.bin"
    path.write_bytes(data)
    dst = np.empty(len(data) - 100, np.uint8)
    tstaging.read_into(path, dst, offset=100, n_threads=4)
    assert dst.tobytes() == data[100:]
    # read_into takes the first engine there is (native, io_uring, preadv).
    first = ("native" if tstaging.has_native() else
             "io_uring" if tstaging.io_uring_available() else "preadv")
    assert tstaging.read_path() == first
    dst[:] = 0
    tstaging.read_into(path, dst, offset=100, n_threads=4, engine="preadv")
    assert dst.tobytes() == data[100:] and tstaging.read_path() == "preadv"
    with pytest.raises(tstaging.StagingError, match="got"):
        tstaging.read_into(path, np.empty(len(data), np.uint8), offset=1)
    whole = tstaging.read_pinned(path)
    assert whole.tobytes() == data and isinstance(whole, np.ndarray)


def test_alloc_pinned_follows_the_target():
    buf = tstaging.alloc_pinned(64, pin=False)
    assert buf.dtype == np.uint8 and buf.size == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tstaging.alloc_pinned(64, pin=True)


def test_read_npy(files):
    np.testing.assert_array_equal(treaders.read_npy(files["c.npy"]), files["arr"])
