"""The port's controller data plane and feed (oim_tpu_torch.controller,
oim_tpu_torch.data.feeds, oim_tpu_torch.spec) held against the JAX
package's on the CPU, in one process.

- ``StageCache``: one scripted sequence of lookups, inserts, releases and
  evictions gives the JAX cache's results step for step.
- ``CUDABackend(device="cpu")`` against ``TPUBackend`` on JAX's CPU
  device: staged bytes equal exactly; the cache, cancel and OOM paths.
- Feeds: the index streams and token batches equal JAX's exactly.
- The slice end to end: llama.tiny trained on a volume staged by the port
  gives the JAX trainer's losses on the same batches within 1e-4 (the
  tolerance of tests/test_torch_train.py: the two frameworks' matmuls sum
  in different orders).
"""

import ast
import sys
import threading
import time
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oim_tpu.controller import stagecache as jstagecache
from oim_tpu.controller.backend import StagedVolume as JStagedVolume
from oim_tpu.controller.backend import reshape_to_spec as jreshape_to_spec
from oim_tpu.controller.tpu_backend import TPUBackend
from oim_tpu.data import feeds as jfeeds
from oim_tpu.data import plane as jplane
from oim_tpu.spec import pb
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch import spec as tspec
from oim_tpu_torch.controller import CUDABackend, MallocBackend, StagedVolume, StageState
from oim_tpu_torch.controller import backend as tbackend
from oim_tpu_torch.controller import stagecache as tstagecache
from oim_tpu_torch.data import feeds as tfeeds
from oim_tpu_torch.data import plane as tplane
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


def stage(backend, kind, params, spec=tspec.ArraySpec(), volume_id="vol"):
    vol = StagedVolume(volume_id, b"", spec)
    backend.stage(vol, kind, params)
    assert vol.wait(60)
    return vol


def jax_stage(kind, params, spec):
    vol = JStagedVolume("vol", b"", spec)
    TPUBackend().stage(vol, kind, params)
    assert vol.wait(60) and not vol.error, vol.error
    return np.asarray(vol.array)


@pytest.fixture
def counted_reads(monkeypatch):
    """Counts plane-path file reads, so "no source re-read" is provable."""
    counts = {"reads": 0}
    orig = tplane.READERS["file"]

    def counting(*args, **kwargs):
        counts["reads"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setitem(tplane.READERS, "file", counting)
    return counts


def _raw(tmp_path, data: bytes, name="v.bin"):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


# ------------------------------------------------------------ spec, backend --


def test_spec_bytes_is_deterministic_and_distinguishes_specs():
    a = tspec.ArraySpec(shape=(4, -1), dtype="int32")
    assert tspec.spec_bytes(a) == tspec.spec_bytes(tspec.ArraySpec((4, -1), "int32"))
    assert len({tspec.spec_bytes(s) for s in (
        a, tspec.ArraySpec((4, -1)), tspec.ArraySpec((4, -1), "int32", ("data", "")),
        tspec.ArraySpec())}) == 4


@pytest.mark.parametrize("name", ["", "uint8", "int32", "bfloat16", "float16", "float64",
                                  "int64", "complex64"])
def test_spec_dtype_maps_names_to_torch(name):
    got = tbackend.spec_dtype(tspec.ArraySpec(dtype=name))
    assert str(got).removeprefix("torch.") == (name or "uint8")


@pytest.mark.parametrize("name", ["float8", "str", "object"])
def test_spec_dtype_refuses_unknown_names(name):
    with pytest.raises(ValueError, match="no torch dtype"):
        tbackend.spec_dtype(tspec.ArraySpec(dtype=name))


@pytest.mark.parametrize("shape,dtype", [((), ""), ((4, -1), ""), ((-1,), "int32"),
                                         ((3, -1), "float16")])
def test_reshape_to_spec_matches_jax(shape, dtype):
    host = np.random.RandomState(0).randint(0, 255, (6, 4)).astype(np.uint8)
    want = jreshape_to_spec(host, pb.ArraySpec(shape=list(shape), dtype=dtype))
    got = tbackend.reshape_to_spec(torch.from_numpy(host), tspec.ArraySpec(shape, dtype))
    assert tuple(got.shape) == want.shape
    assert _bytes_of(got) == np.ascontiguousarray(want).tobytes()


def test_volume_status_and_wait():
    vol = StagedVolume("v", b"", tspec.ArraySpec())
    assert not vol.wait(timeout=0.01)
    assert vol.status() == tspec.StageStatus(False, 0, 0.0, "")
    vol.mark_ready(torch.zeros(8, dtype=torch.uint8), 8)
    st = vol.status()
    assert vol.wait(0) and st.ready and st.bytes_staged == 8 and st.gbps > 0 and not st.error


# -------------------------------------------------------------- stage cache --


def test_stage_cache_scripted_sequence_matches_jax():
    """Both caches at 100 bytes through one script: hits, LRU eviction,
    pinned entries surviving pressure, stale-locator invalidation, the
    too-big insert, keep=False release and evict_idle."""
    script = [
        ("insert", "k1", 40, ("a",), "s1"), ("release", "k1", True),
        ("insert", "k2", 40, ("b",), "s2"),
        ("lookup", "k1"), ("release", "k1", True),
        ("insert", "k3", 40, ("c",), "s3"),          # evicts the LRU idle entry
        ("lookup", "k2"), ("lookup", "k3"),
        ("insert", "k4", 30, ("a",), "s1b"),         # stale "a" entries go first
        ("insert", "k5", 150, ("d",), "s5"),         # too big: uncached
        ("release", "k5", True), ("release", "k3", False),
        ("lookup", "k4"), ("release", "k4", True), ("release", "k4", True),
        ("evict_idle",), ("lookup", "k2"),
    ]
    results = []
    for mod in (jstagecache, tstagecache):
        cache, entries, out = mod.StageCache(100), {}, []
        for op in script:
            if op[0] == "insert":
                entries[op[1]] = cache.insert(op[1], object(), op[2], op[3], source_sig=op[4])
                out.append(("insert", entries[op[1]].pins))
            elif op[0] == "lookup":
                e = cache.lookup(op[1])
                out.append(("lookup", e is not None))
                if e is not None:
                    entries[op[1]] = e
            elif op[0] == "release":
                cache.release(entries[op[1]], keep=op[2])
                out.append(("release", entries[op[1]].array is None))
            else:
                out.append(("evict_idle", cache.evict_idle()))
            st = cache.stats()
            out.append({k: st[k] for k in ("entries", "bytes", "pinned", "capacity_bytes")})
        results.append(out)
    assert results[0] == results[1]


def test_stage_cache_counts_and_capacity_zero():
    cache = tstagecache.StageCache(0)
    e = cache.insert("k", object(), 10, ("a",))
    assert len(cache) == 0 and e.pins == 1
    cache.count(hit=True)
    cache.count(hit=False)
    cache.release(e)
    assert e.array is None
    st = cache.stats()
    assert (st["hits"], st["misses"], st["evictions"]) == (1, 1, 0)


def test_fingerprint_follows_the_file(tmp_path):
    path = _raw(tmp_path, b"a" * 100)
    src = tplane.lower_source("file", tspec.FileParams(path))
    fp = tstagecache.fingerprint_source(src)
    jfp = jstagecache.fingerprint_source(jplane.lower_source(
        "file", pb.FileParams(path=path)))
    assert fp == jfp
    key = tstagecache.content_key("file", fp, b"spec", ("device",))
    assert key == jstagecache.content_key("file", jfp, b"spec", ("device",))
    src.extents.append(tplane.Extent("object", "http://x/o", 0, 1))
    assert tstagecache.fingerprint_source(src) is None


# ------------------------------------------------------------- CUDABackend --


@pytest.mark.parametrize("case", ["raw-uint8", "raw-int32-shaped", "raw-bfloat16",
                                  "npy", "npy-float16-view", "raw-f4", "raw-<f4",
                                  "raw-i4"])
def test_cuda_backend_bytes_equal_tpu_backend(tmp_path, case):
    rs = np.random.RandomState(4)
    raw_path = _raw(tmp_path, rs.bytes(4096))
    npy = tmp_path / "t.npy"
    np.save(npy, rs.randint(0, 1 << 16, (16, 32)).astype(np.int32))
    kind, path, fmt, shape, dtype = {
        "raw-uint8": ("raw", raw_path, "raw", (), ""),
        "raw-int32-shaped": ("raw", raw_path, "raw", (8, -1), "int32"),
        "raw-bfloat16": ("raw", raw_path, "raw", (-1, 64), "bfloat16"),
        "npy": ("npy", str(npy), "npy", (), ""),
        "npy-float16-view": ("npy", str(npy), "npy", (32, -1), "float16"),
        # numpy's spellings, resolved through np.dtype as JAX resolves them
        "raw-f4": ("raw", raw_path, "raw", (-1,), "f4"),
        "raw-<f4": ("raw", raw_path, "raw", (16, -1), "<f4"),
        "raw-i4": ("raw", raw_path, "raw", (), "i4"),
    }[case]
    want = jax_stage("file", pb.FileParams(path=path, format=fmt),
                     pb.ArraySpec(shape=list(shape), dtype=dtype))
    vol = stage(CUDABackend(device="cpu", chunk_bytes=1000), "file",
                tspec.FileParams(path, fmt), tspec.ArraySpec(shape, dtype))
    assert vol.state == StageState.READY, vol.error
    assert tuple(vol.array.shape) == want.shape
    assert _bytes_of(vol.array) == np.ascontiguousarray(want).tobytes()
    assert vol.total_bytes == vol.bytes_staged == want.nbytes and vol.device_id == 0


def test_cuda_backend_keeps_64_bit_bytes_where_jax_converts(tmp_path):
    arr = np.random.RandomState(5).randn(10, 20)
    np.save(tmp_path / "f64.npy", arr)
    params = (str(tmp_path / "f64.npy"), "npy")
    want = jax_stage("file", pb.FileParams(path=params[0], format="npy"), pb.ArraySpec())
    assert want.dtype == np.float32  # JAX with x64 off converts values
    vol = stage(CUDABackend(device="cpu"), "file", tspec.FileParams(*params))
    assert vol.array.dtype == torch.float64
    np.testing.assert_array_equal(vol.array.numpy(), arr)
    np.testing.assert_allclose(vol.array.numpy(), want, rtol=1e-7)


def test_float_spelling_stages_64_bit_bytes_where_jax_converts(tmp_path):
    """"float" is numpy's float64: JAX (x64 off) stages its values as
    float32, the port keeps the 64-bit bytes."""
    arr = np.random.RandomState(7).randn(64, 8)
    path = _raw(tmp_path, arr.tobytes())
    want = jax_stage("file", pb.FileParams(path=path, format="raw"),
                     pb.ArraySpec(shape=[64, -1], dtype="float"))
    assert want.dtype == np.float32
    vol = stage(CUDABackend(device="cpu"), "file", tspec.FileParams(path, "raw"),
                tspec.ArraySpec((64, -1), "float"))
    assert vol.state == StageState.READY, vol.error
    assert vol.array.dtype == torch.float64 and _bytes_of(vol.array) == arr.tobytes()
    np.testing.assert_allclose(vol.array.numpy(), want, rtol=1e-7)


def test_restage_after_unstage_hits_without_rereading(tmp_path, counted_reads):
    data = np.random.RandomState(0).bytes(50_000)
    path = _raw(tmp_path, data)
    backend = CUDABackend(device="cpu", chunk_bytes=8192)
    vol = stage(backend, "file", tspec.FileParams(path))
    assert _bytes_of(vol.array) == data
    reads, calls, ptr = counted_reads["reads"], tplane.STAGE_CALLS, vol.array.data_ptr()
    assert reads > 0
    backend.unstage(vol)
    assert vol.array is None
    again = stage(backend, "file", tspec.FileParams(path))
    assert counted_reads["reads"] == reads and tplane.STAGE_CALLS == calls
    assert again.array.data_ptr() == ptr and _bytes_of(again.array) == data
    assert backend.cache.stats()["hits"] == 1


def test_changed_file_misses(tmp_path, counted_reads):
    path = _raw(tmp_path, b"a" * 10_000)
    backend = CUDABackend(device="cpu")
    backend.unstage(stage(backend, "file", tspec.FileParams(path)))
    before = counted_reads["reads"]
    time.sleep(0.01)
    _raw(tmp_path, b"b" * 10_000)  # same size, new mtime and content
    vol = stage(backend, "file", tspec.FileParams(path))
    assert counted_reads["reads"] > before
    assert _bytes_of(vol.array) == b"b" * 10_000
    assert len(backend.cache) == 1  # the stale entry was invalidated


def test_keep_cached_false_frees_on_unstage(tmp_path, counted_reads):
    path = _raw(tmp_path, b"x" * 4_000)
    backend = CUDABackend(device="cpu", keep_cached=False)
    vol = stage(backend, "file", tspec.FileParams(path))
    ref = weakref.ref(vol.array)
    before = counted_reads["reads"]
    backend.unstage(vol)
    assert ref() is None and len(backend.cache) == 0
    vol = stage(backend, "file", tspec.FileParams(path))
    assert counted_reads["reads"] > before and _bytes_of(vol.array) == b"x" * 4_000


def test_uncached_tensor_is_dropped_on_unstage(tmp_path):
    path = _raw(tmp_path, b"y" * 4_000)
    backend = CUDABackend(device="cpu", cache_bytes=1_000)  # too small to hold it
    vol = stage(backend, "file", tspec.FileParams(path))
    ref = weakref.ref(vol.array)
    assert vol.cache_entry is not None and len(backend.cache) == 0
    backend.unstage(vol)
    assert ref() is None


def test_two_volume_ids_share_one_entry(tmp_path, counted_reads):
    data = b"z" * 20_000
    path = _raw(tmp_path, data)
    backend = CUDABackend(device="cpu")
    a = stage(backend, "file", tspec.FileParams(path), volume_id="vol-a")
    before = counted_reads["reads"]
    b = stage(backend, "file", tspec.FileParams(path), volume_id="vol-b")
    assert counted_reads["reads"] == before and a.array.data_ptr() == b.array.data_ptr()
    backend.unstage(a)
    assert _bytes_of(b.array) == data and backend.cache.stats()["pinned"] == 1


def test_malloc_buffers_are_never_cached():
    for backend in (MallocBackend(), CUDABackend(device="cpu")):
        backend.provision("buf", 1024)
        backend.buffer("buf")[:] = 9
        vol = stage(backend, "malloc", tspec.MallocParams(), volume_id="buf")
        assert vol.state == StageState.READY and _bytes_of(vol.array) == b"\x09" * 1024
        assert len(backend.cache) == 0 and backend.check("buf")


def test_prestage_warms_then_stage_hits(tmp_path, counted_reads):
    data = np.random.RandomState(1).bytes(30_000)
    path = _raw(tmp_path, data)
    backend = CUDABackend(device="cpu")
    pre = backend.prestage("file", tspec.FileParams(path), tspec.ArraySpec())
    assert pre.wait(30) and pre.state == StageState.READY
    assert wait_for(lambda: len(backend.cache) == 1 and backend.cache.stats()["pinned"] == 0)
    reads = counted_reads["reads"]
    vol = stage(backend, "file", tspec.FileParams(path))
    assert counted_reads["reads"] == reads and _bytes_of(vol.array) == data


def test_unstage_mid_stage_cancels(tmp_path, monkeypatch):
    path = _raw(tmp_path, b"q" * (1 << 20))
    backend = CUDABackend(device="cpu", chunk_bytes=32 << 10, keep_cached=False)
    started = threading.Event()
    orig = tplane.READERS["file"]

    def slow_reader(*args, **kwargs):
        started.set()
        time.sleep(0.02)
        return orig(*args, **kwargs)

    monkeypatch.setitem(tplane.READERS, "file", slow_reader)
    refs = []
    orig_empty = tplane._device_empty
    monkeypatch.setattr(tplane, "_device_empty", lambda n, d: refs.append(
        weakref.ref(buf := orig_empty(n, d))) or buf)
    vol = StagedVolume("vol", b"", tspec.ArraySpec())
    backend.stage(vol, "file", tspec.FileParams(path))
    assert started.wait(10)
    backend.unstage(vol)
    assert vol.wait(30)
    assert vol.state == StageState.FAILED and vol.error == "unmapped during staging"
    assert 0 < vol.bytes_staged < (1 << 20)
    assert wait_for(lambda: refs and refs[0]() is None)
    assert backend.cache.stats()["pinned"] == 0


def test_oom_valve_evicts_idle_entries_and_retries_once(tmp_path, monkeypatch):
    backend = CUDABackend(device="cpu")
    backend.unstage(stage(backend, "file", tspec.FileParams(_raw(tmp_path, b"i" * 5000, "idle"))))
    assert len(backend.cache) == 1
    calls = []
    orig = tplane._device_empty

    def short_of_memory(nbytes, device):
        calls.append(nbytes)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return orig(nbytes, device)

    monkeypatch.setattr(tplane, "_device_empty", short_of_memory)
    vol = stage(backend, "file", tspec.FileParams(_raw(tmp_path, b"n" * 3000, "new")))
    assert vol.state == StageState.READY and _bytes_of(vol.array) == b"n" * 3000
    assert calls == [3000, 3000]
    assert backend.cache.stats()["evictions"] == 1 and len(backend.cache) == 1


def test_oom_without_idle_entries_fails_the_volume(tmp_path, monkeypatch):
    def no_memory(nbytes, device):
        raise torch.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(tplane, "_device_empty", no_memory)
    vol = stage(CUDABackend(device="cpu"), "file", tspec.FileParams(_raw(tmp_path, b"n" * 300)))
    assert vol.state == StageState.FAILED and "out of memory" in vol.error


def test_fortran_npy_takes_the_whole_read_path(tmp_path):
    arr = np.asfortranarray(np.arange(60, dtype=np.int32).reshape(6, 10))
    np.save(tmp_path / "f.npy", arr)
    want = jax_stage("file", pb.FileParams(path=str(tmp_path / "f.npy"), format="npy"),
                     pb.ArraySpec())
    calls = tplane.STAGE_CALLS
    vol = stage(CUDABackend(device="cpu"), "file",
                tspec.FileParams(str(tmp_path / "f.npy"), "npy"))
    assert vol.state == StageState.READY and tplane.STAGE_CALLS == calls
    np.testing.assert_array_equal(vol.array.numpy(), want)
    np.testing.assert_array_equal(vol.array.numpy(), arr)


def test_sharded_spec_raises(tmp_path):
    vol = stage(CUDABackend(device="cpu"), "file", tspec.FileParams(_raw(tmp_path, b"s" * 64)),
                tspec.ArraySpec((8, 8), "uint8", ("data", "")))
    assert vol.state == StageState.FAILED and "sharding" in vol.error


def test_missing_file_and_unported_kinds_fail_the_volume(tmp_path):
    backend = CUDABackend(device="cpu")
    vol = stage(backend, "file", tspec.FileParams(str(tmp_path / "nope.bin")))
    assert vol.state == StageState.FAILED and "nope.bin" in vol.error
    # Every source kind is ported: a ceph volume without its gateway fails.
    vol = stage(backend, "ceph", tspec.CephParams(pool="rbd", image="vol"))
    assert vol.state == StageState.FAILED and "monitors" in vol.error


def test_cuda_backend_defaults_to_cuda():
    import inspect

    assert inspect.signature(CUDABackend).parameters["device"].default == "cuda"
    backend = CUDABackend(device="cpu")
    assert [backend._pick_device() for _ in range(3)] == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDABackend()


# -------------------------------------------------------------------- feeds --


@pytest.mark.parametrize("n,batch,seed,start", [(10, 3, None, 0), (10, 3, None, 7),
                                                (10, 4, 5, 0), (10, 4, 5, 6), (3, 4, 1, 2)])
def test_cycle_indices_match_jax(n, batch, seed, start):
    j, t = (m._cycle_indices(n, batch, seed, start) for m in (jfeeds, tfeeds))
    for _ in range(12):
        np.testing.assert_array_equal(next(t), next(j))


def _token_volume(tmp_path, n=5 * 17 + 9, vocab=256):
    tokens = np.random.RandomState(6).randint(0, vocab, n).astype(np.int32)
    path = tmp_path / "tokens.npy"
    np.save(path, tokens)
    return tokens, str(path)


@pytest.mark.parametrize("seed,start", [(None, 0), (3, 2)])
def test_volume_token_batches_equal_jax(tmp_path, seed, start):
    tokens, path = _token_volume(tmp_path)
    jcfg = jtrainer.TrainConfig(batch_size=2, seq_len=16)
    jarr = jax_stage("file", pb.FileParams(path=path, format="npy"), pb.ArraySpec())
    vol = stage(CUDABackend(device="cpu"), "file", tspec.FileParams(path, "npy"))
    want = jfeeds._cycle_token_batches(np.asarray(jarr), jcfg, "vol", seed, start)
    plain = tfeeds._cycle_token_batches(tokens, jcfg, "vol", seed, start)
    got = tfeeds.volume_token_batches(vol.array, ttrainer.TrainConfig(batch_size=2, seq_len=16),
                                      seed, start)
    for _ in range(7):
        w, p, g = next(want)["tokens"], next(plain)["tokens"], next(got)["tokens"]
        assert g.dtype == torch.int32 and g.device == vol.array.device
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(p, w)


def test_volume_too_short_for_one_record(tmp_path):
    with pytest.raises(SystemExit, match="tokens < seq_len"):
        next(tfeeds.volume_token_batches(torch.zeros(10, dtype=torch.int32),
                                         ttrainer.TrainConfig(seq_len=16)))


def test_seekable_feed_is_lazy_and_repositions():
    made = []

    def make(start):
        made.append(start)
        return iter(range(start, 100))

    feed = tfeeds.SeekableFeed(make)
    assert made == []
    assert [next(feed), next(feed)] == [0, 1]
    feed.seek(40)
    assert made == [0] and next(feed) == 40 and made == [0, 40]


# ------------------------------------------------------------ the slice e2e --


def _cfgs():
    common = dict(model="llama-tiny", batch_size=2, seq_len=16, lr=1e-2, warmup_steps=1,
                  total_steps=10, log_every=1, seed=3)
    return jtrainer.TrainConfig(**common), ttrainer.TrainConfig(**common)


def test_place_batch_takes_tensors_and_numpy_alike():
    _, tcfg = _cfgs()
    batch = next(ttrainer.synthetic_batches(tcfg))
    losses = []
    for as_tensor in (False, True):
        tr = ttrainer.Trainer(tcfg, device="cpu")
        tr.init()
        b = {"tokens": torch.from_numpy(batch["tokens"])} if as_tensor else batch
        placed = tr.place_batch(b)
        if as_tensor:
            assert placed["tokens"] is b["tokens"]  # already on the device: untouched
        tr.state, stats = tr.step_fn(tr.state, placed)
        losses.append(float(stats["loss"]))
    assert losses[0] == losses[1]


def test_training_on_a_staged_volume_matches_jax(tmp_path):
    """llama.tiny, 3 steps on a token volume staged by CUDABackend on the
    CPU, against the JAX trainer's step on the batches JAX's feed cuts
    from the same volume staged by TPUBackend."""
    jcfg, tcfg = _cfgs()
    tokens, path = _token_volume(tmp_path, n=40 * 17, vocab=tllama.tiny().vocab)
    jarr = jax_stage("file", pb.FileParams(path=path, format="npy"), pb.ArraySpec())
    jtr = jtrainer.Trainer(jcfg, axes=[("data", 1)])
    jtr.init_or_resume()
    init = jax.tree.map(np.asarray, jtr.state.params)
    jlosses = []
    jdata = jfeeds._cycle_token_batches(np.asarray(jarr), jcfg, "vol", 7)
    for _ in range(3):
        jtr.state, stats = jtr.step_fn(jtr.state, jtr.place_batch(next(jdata)))
        jlosses.append(float(stats["loss"]))

    vol = stage(CUDABackend(device="cpu"), "file", tspec.FileParams(path, "npy"))
    tr = ttrainer.Trainer(tcfg, device="cpu")
    tr.init(tllama.from_numpy(init, device="cpu"))
    tr.run(steps=3, data=tfeeds.volume_token_batches(vol.array, tcfg, shuffle_seed=7))
    np.testing.assert_allclose([r["loss"] for r in tr.history], jlosses, atol=1e-4)


# -------------------------------------------------------------------- rules --

_ROOT = Path(__file__).resolve().parent.parent


# The gRPC surface: the only modules of the port that may import grpc and
# protobuf. Nothing on the card's path imports them (test_torch_wire.py
# holds that in a fresh interpreter).
GRPC_SURFACE = {
    "spec/oim_pb2.py", "spec/services.py", "common/endpoints.py", "common/tlsutil.py",
    "common/channelpool.py", "common/interceptors.py", "common/server.py",
    "common/identity.py", "common/rpctelemetry.py", "common/rpcfault.py",
    "controller/controller.py", "feeder/__init__.py", "feeder/driver.py",
    "feeder/emulation.py", "feeder/watch.py", "cli/oim_controller.py",
    "common/telemetry.py", "serve/registration.py", "serve/service.py", "serve/members.py",
    "cli/oim_serve.py", "feeder/service.py", "parallel/bootstrap.py",
    "registry/registry.py", "registry/replication.py", "registry/quorum.py",
    "registry/watch.py", "router/table.py", "router/router.py",
    "chaos/sim.py", "chaos/ladder.py", "obs/monitor.py", "autoscale/daemon.py"}
# Pillow is not on the card machine either: only the image helpers import
# it, inside the functions the CPU's image feeds call.
PILLOW_USERS = {"data/readers.py"}


def test_data_plane_modules_import_only_stdlib_numpy_torch_and_the_port():
    """The card machine lists no grpc, protobuf, prometheus_client or
    ml_dtypes; no module of the port needs them, nor JAX, and neither does
    chip_smoke.py, which runs there, but the gRPC surface, which may import
    grpc and protobuf and nothing else beyond."""
    port = _ROOT / "oim_tpu_torch"
    files = sorted(port.rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    assert len(files) >= 47
    assert port / "models" / "moe.py" in files and port / "cli" / "oim_infer.py" in files
    assert port / "data" / "objectstore.py" in files and port / "data" / "webdataset.py" in files
    surface = {str(p.relative_to(port)) for p in files if p.is_relative_to(port)} \
        & GRPC_SURFACE
    assert surface == GRPC_SURFACE
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch", "oim_tpu_torch"}
    bad = []
    for path in files:
        rel = str(path.relative_to(port)) if path.is_relative_to(port) else path.name
        ok = allowed | ({"grpc", "google"} if rel in GRPC_SURFACE else set()) \
            | ({"PIL"} if rel in PILLOW_USERS else set())
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] not in ok]
    assert not bad, bad
