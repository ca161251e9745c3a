"""The port's read engines (oim_tpu_torch.data.staging) held against the
JAX package's ``read_into`` on the CPU, in one process.

The native engine is built from ``native/staging.cc`` into the port's own
build directory; its tests skip only where there is no C++ compiler. The
io_uring tests skip only where the kernel refuses ``io_uring_setup``.
Every read is compared with the file and with JAX's read, byte for byte.
"""

import os
import shutil
import sys
import threading

import numpy as np
import pytest

from oim_tpu.data import staging as jstaging
from oim_tpu_torch.data import staging as tstaging

# (offset, length): whole, at an offset, many 4 MiB pieces across thread
# spans, a short tail, one byte, nothing.
CASES = [(0, None), (12345, None), (1, 9 * (4 << 20) + 3), ((4 << 20) - 1, 5), (7, 1), (0, 0)]


@pytest.fixture(scope="module")
def native():
    if shutil.which(tstaging.compiler()) is None:
        pytest.skip(f"no C++ compiler ({tstaging.compiler()}) to build the native engine")
    path = tstaging.build()
    lib = tstaging.native_lib()
    assert lib is not None
    return path


def _uring_or_skip():
    if not tstaging.io_uring_available():
        pytest.skip(f"io_uring unavailable: {tstaging.io_uring_error()}")


@pytest.fixture(scope="module")
def datafile(tmp_path_factory):
    data = np.random.default_rng(0).integers(0, 256, 10 * (4 << 20) + 12345, dtype=np.uint8)
    path = tmp_path_factory.mktemp("staging") / "blob.bin"
    data.tofile(path)
    return str(path), data


def _engine_ready(engine: str, request) -> None:
    if engine == "native":
        request.getfixturevalue("native")
    elif engine == "io_uring":
        _uring_or_skip()


@pytest.mark.parametrize("engine", tstaging.ENGINES)
@pytest.mark.parametrize("offset,length", CASES)
def test_each_engine_reads_what_jax_read_into_reads(request, datafile, engine, offset, length):
    _engine_ready(engine, request)
    path, data = datafile
    n = data.size - offset if length is None else length
    got = np.full(n, 0xAB, np.uint8)
    tstaging.read_into(path, got, offset=offset, engine=engine)
    assert tstaging.read_path() == engine
    want = np.zeros(n, np.uint8)
    jstaging.read_into(path, want, offset=offset)
    assert np.array_equal(got, want)
    assert np.array_equal(got, data[offset:offset + n])


@pytest.mark.parametrize("engine", tstaging.ENGINES)
def test_each_engine_reads_into_a_slice_of_a_larger_buffer(request, datafile, engine):
    _engine_ready(engine, request)
    path, data = datafile
    buf = np.zeros(1 << 20, np.uint8)
    tstaging.read_into(path, buf[1000:1000 + 5000], offset=333, engine=engine, n_threads=3)
    assert not buf[:1000].any() and not buf[6000:].any()
    assert np.array_equal(buf[1000:6000], data[333:5333])


@pytest.mark.parametrize("engine", tstaging.ENGINES)
def test_each_engine_raises_on_a_short_file_as_jax(request, datafile, engine, tmp_path):
    _engine_ready(engine, request)
    path, data = datafile
    with pytest.raises(tstaging.StagingError, match=f"got {data.size - 10} of {data.size}"):
        tstaging.read_into(path, np.empty(data.size, np.uint8), offset=10, engine=engine)
    with pytest.raises(jstaging.StagingError, match=f"got {data.size - 10} of {data.size}"):
        jstaging.read_into(path, np.empty(data.size, np.uint8), offset=10)
    with pytest.raises(tstaging.StagingError):
        tstaging.read_into(str(tmp_path / "missing"), np.empty(8, np.uint8), engine=engine)


@pytest.mark.parametrize("engine", tstaging.ENGINES)
def test_concurrent_reads_of_one_engine_stay_byte_identical(request, datafile, engine):
    """Many threads (more than cores) share one engine: the io_uring
    ring and the loaded library are process-wide. Each thread reads its
    own ranges under a short switch interval and checks them."""
    _engine_ready(engine, request)
    path, data = datafile
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(6):
                off = int(rng.integers(0, data.size - 1))
                n = int(rng.integers(1, min(data.size - off, 6 << 20) + 1))
                dst = np.empty(n, np.uint8)
                tstaging.read_into(path, dst, offset=off, engine=engine, n_threads=2)
                if not np.array_equal(dst, data[off:off + n]):
                    errors.append(f"thread {seed}: [{off}, +{n}) differs")
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"thread {seed}: {exc!r}")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]


def test_the_build_is_the_ports_own(native):
    assert native.parent == tstaging.BUILD_DIR and native.exists()
    assert native.name.startswith("libstaging-") and native.suffix == ".so"
    assert tstaging.native_lib()._name == str(native)
    assert native == tstaging.lib_path(tstaging.has_jpeg())
    assert tstaging.lib_path(True).name.endswith("-jpeg.so")
    assert tstaging.native_lib().oim_staging_abi_version() == 1


def test_build_is_atomic_under_concurrent_builders(monkeypatch, tmp_path):
    if shutil.which(tstaging.compiler()) is None:
        pytest.skip("no C++ compiler to build the native engine")
    monkeypatch.setattr(tstaging, "BUILD_DIR", tmp_path / "build")
    out, errors = [], []

    def build():
        try:
            out.append(tstaging.build())
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(out)) == 1 and out[0].exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [out[0].name]


def test_the_default_engine_is_the_first_there_is(native, datafile, monkeypatch):
    path, data = datafile
    dst = np.empty(100, np.uint8)
    tstaging.read_into(path, dst)
    assert tstaging.read_path() == "native"
    monkeypatch.setattr(tstaging, "_lib", False)  # the engine not built
    tstaging.read_into(path, dst)
    assert tstaging.read_path() == ("io_uring" if tstaging.io_uring_available() else "preadv")
    monkeypatch.setattr(tstaging, "_uring", False)
    tstaging.read_into(path, dst)
    assert tstaging.read_path() == "preadv"
    assert np.array_equal(dst, data[:100])
    with pytest.raises(tstaging.StagingError, match="not built"):
        tstaging.read_into(path, dst, engine="native")


def test_io_uring_off_by_environment_names_the_reason(monkeypatch):
    monkeypatch.setattr(tstaging, "_uring", None)
    monkeypatch.setenv("OIM_IO_URING", "0")
    assert not tstaging.io_uring_available()
    assert tstaging.io_uring_error() == "OIM_IO_URING=0"
    with pytest.raises(tstaging.StagingError, match="OIM_IO_URING=0"):
        tstaging.read_into(__file__, np.empty(4, np.uint8), engine="io_uring")
    monkeypatch.setattr(tstaging, "_uring", None)
    monkeypatch.delenv("OIM_IO_URING")
    assert tstaging.io_uring_available() == (tstaging.io_uring_error() == "")


def test_read_into_refuses_unknown_engines_and_strided_buffers(datafile):
    path, _ = datafile
    with pytest.raises(ValueError, match="unknown read engine"):
        tstaging.read_into(path, np.empty(4, np.uint8), engine="dma")
    with pytest.raises(ValueError, match="contiguous uint8"):
        tstaging.read_into(path, np.empty(8, np.uint8)[::2])
    with pytest.raises(ValueError, match="contiguous uint8"):
        tstaging.read_into(path, np.empty(4, np.int32))


def test_read_pinned_matches_jax(native, datafile):
    path, data = datafile
    got = tstaging.read_pinned(path)
    assert got.dtype == np.uint8 and np.array_equal(got, data)
    assert np.array_equal(got, jstaging.read_pinned(path))


@pytest.mark.parametrize("chunk", [1 << 20, 3 * (1 << 20) + 7, 64 << 20])
def test_stream_yields_the_file_in_order_as_jax(native, datafile, chunk):
    path, data = datafile
    got = [c.copy() for c in tstaging.stream(path, chunk_bytes=chunk, n_buffers=3)]
    want = [c.copy() for c in jstaging.stream(path, chunk_bytes=chunk, n_buffers=3)]
    assert [c.size for c in got] == [c.size for c in want]
    assert np.array_equal(np.concatenate(got), data)
    assert all(c.size == chunk for c in got[:-1])


def test_stream_without_the_engine_reads_on_the_calling_thread(datafile, monkeypatch):
    path, data = datafile
    monkeypatch.setattr(tstaging, "_lib", False)
    got = list(tstaging.stream(path, chunk_bytes=5 << 20))
    assert np.array_equal(np.concatenate(got), data)


def test_stream_raises_on_a_missing_file(native, tmp_path):
    with pytest.raises(tstaging.StagingError, match="open"):
        list(tstaging.stream(str(tmp_path / "missing")))


def test_alloc_pinned_without_pin_is_plain_memory():
    arr = tstaging.alloc_pinned(1000, pin=False)
    assert arr.dtype == np.uint8 and arr.size == 1000 and arr.flags.c_contiguous
    assert tstaging.alloc_pinned(-5, pin=False).size == 0


def test_the_engine_is_never_compiled_by_a_read(monkeypatch, tmp_path, datafile):
    """Loading finds no library in an empty build directory and reads on;
    nothing is compiled."""
    path, data = datafile
    monkeypatch.setattr(tstaging, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(tstaging, "_lib", None)
    dst = np.empty(64, np.uint8)
    tstaging.read_into(path, dst)
    assert tstaging.read_path() in ("io_uring", "preadv") and np.array_equal(dst, data[:64])
    assert not os.path.exists(tmp_path / "empty")
