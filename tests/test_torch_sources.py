"""The port's sources (oim_tpu_torch.data.{readers,webdataset,objectstore},
controller.source, plane.lower_source, the stage cache's object
fingerprint, feeds._wds_tokens) held against the JAX package's on the CPU,
in one process.

Bytes are copied, never converted, so every comparison is exact. A local
ThreadingHTTPServer that honours Range, HEAD, ETag and HTTP Basic auth
stands in for the object gateway.
"""

import base64
import dataclasses
import http.server
import io
import tarfile
import threading
import time

import numpy as np
import pytest
import torch

from oim_tpu.controller import MallocBackend as JMallocBackend
from oim_tpu.controller import source as jsource
from oim_tpu.controller import stagecache as jstagecache
from oim_tpu.controller.backend import StagedVolume as JStagedVolume
from oim_tpu.controller.tpu_backend import TPUBackend
from oim_tpu.data import feeds as jfeeds
from oim_tpu.data import objectstore as jobjectstore
from oim_tpu.data import plane as jplane
from oim_tpu.data import readers as jreaders
from oim_tpu.data import webdataset as jwebdataset
from oim_tpu.spec import pb
from oim_tpu_torch import spec as tspec
from oim_tpu_torch.common import logging as tlogging
from oim_tpu_torch.controller import CUDABackend, MallocBackend, StagedVolume, StageState
from oim_tpu_torch.controller import source as tsource
from oim_tpu_torch.controller import stagecache as tstagecache
from oim_tpu_torch.data import feeds as tfeeds
from oim_tpu_torch.data import objectstore as tobjectstore
from oim_tpu_torch.data import plane as tplane
from oim_tpu_torch.data import readers as treaders
from oim_tpu_torch.data import webdataset as twebdataset


@pytest.fixture(autouse=True, scope="module")
def quiet_port_logger():
    """The plaintext-credentials and retry warnings are expected here; keep
    them out of the test log."""
    prev = tlogging.set_global(tlogging.Logger(level=tlogging.ERROR))
    yield
    tlogging.set_global(prev)


# ------------------------------------------------------------ the gateway --


class _Handler(http.server.BaseHTTPRequestHandler):
    """Serves ``server.objects`` {path: (bytes, etag)} with Range, HEAD,
    ETag, optional Basic auth, optional HEAD refusal and injected 503s."""

    def log_message(self, *args):
        pass

    def _object(self):
        srv = self.server
        with srv.lock:
            srv.requests.append((self.command, self.path, self.headers.get("Range")))
            if srv.fail_next > 0:
                srv.fail_next -= 1
                self.send_error(503, "busy")
                return None
        need = srv.auth.get(self.path)
        if need and self.headers.get("Authorization") != need:
            self.send_error(401, "unauthorized")
            return None
        obj = srv.objects.get(self.path)
        if obj is None:
            self.send_error(404, "not found")
            return None
        return obj

    def _validators(self, etag):
        if etag:
            self.send_header("ETag", etag)

    def do_HEAD(self):
        if self.server.refuse_head:
            self.send_error(405, "no HEAD")
            return
        obj = self._object()
        if obj is None:
            return
        data, etag = obj
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self._validators(etag)
        self.end_headers()

    def do_GET(self):
        obj = self._object()
        if obj is None:
            return
        data, etag = obj
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo, _, hi = rng[len("bytes="):].partition("-")
            start = int(lo)
            end = min(int(hi) if hi else len(data) - 1, len(data) - 1)
            body = memoryview(data)[start:end + 1]
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{start + len(body) - 1}/{len(data)}")
        else:
            body = memoryview(data)
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self._validators(etag)
        self.end_headers()
        self.wfile.write(body)


class _Gateway(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.objects: dict[str, tuple[bytes, str]] = {}
        self.auth: dict[str, str] = {}  # path -> the Authorization it needs
        self.refuse_head = False
        self.fail_next = 0
        self.requests: list[tuple] = []
        self.lock = threading.Lock()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server_port}"

    def put(self, path: str, data: bytes, etag: str = '"v1"') -> str:
        self.objects[path] = (bytes(data), etag)
        return self.url + path

    def gets(self) -> int:
        with self.lock:
            return sum(1 for r in self.requests if r[0] == "GET")


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


# ---------------------------------------------------------------- helpers --


def _records(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, 3000, n)] + [b""]


def _examples(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{
        "image/encoded": rng.bytes(int(rng.integers(1, 2000))),
        "image/class/label": int(rng.integers(1, 1001)),
        "image/height": int(rng.integers(1, 512)),
        "image/width": int(rng.integers(1, 512)),
        "image/format": b"JPEG",
        "offsets": [int(x) for x in rng.integers(-2**40, 2**40, 3)],
        "scores": rng.standard_normal(4).astype(np.float32).tolist(),
        "tags": [b"a", b"bc", b""],
    } for _ in range(n)]


def _tar(members: list[tuple[str, bytes]]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in members:
            if name.endswith("/"):
                info = tarfile.TarInfo(name.rstrip("/"))
                info.type = tarfile.DIRTYPE
                tf.addfile(info)
                continue
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _token_shard(seed: int, n_samples: int, span: int = 17) -> tuple[bytes, np.ndarray]:
    """A webdataset shard of ``n_samples`` samples, each a .bin of ``span``
    int32 tokens and a .cls label, plus the tokens it holds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 1000, (n_samples, span), dtype=np.int32)
    members = []
    for i, row in enumerate(toks):
        members.append((f"s{seed:02d}/{i:06d}.bin", row.tobytes()))
        members.append((f"s{seed:02d}/{i:06d}.cls", str(i % 7).encode()))
    return _tar(members), toks.reshape(-1)


def _write(tmp_path, name: str, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _params(kind: str, **fields):
    """(the JAX package's proto message, the port's dataclass) of one
    source."""
    if kind == "file":
        return pb.FileParams(**fields), tspec.FileParams(**fields)
    if kind == "tfrecord":
        return pb.TFRecordParams(**fields), tspec.TFRecordParams(tuple(fields["paths"]))
    if kind == "webdataset":
        return (pb.WebDatasetParams(**fields),
                tspec.WebDatasetParams(tuple(fields["shard_urls"])))
    return pb.CephParams(**fields), tspec.CephParams(**fields)


def _auth(user: str, secret: str) -> str:
    return "Basic " + base64.b64encode(f"{user}:{secret}".encode()).decode()


def _stage(backend, kind, params, spec=tspec.ArraySpec(), volume_id="vol"):
    vol = StagedVolume(volume_id, b"", spec)
    backend.stage(vol, kind, params)
    assert vol.wait(60)
    return vol


def _jax_stage(kind, params) -> np.ndarray:
    vol = JStagedVolume("vol", b"", pb.ArraySpec())
    TPUBackend().stage(vol, kind, params)
    assert vol.wait(60) and not vol.error, vol.error
    return np.asarray(vol.array)


@pytest.fixture
def sources(tmp_path, gateway):
    """One volume of each kind, on disk or behind the gateway, with its
    expected bytes."""
    recs = [treaders.encode_example(e) for e in _examples(0, 12)]
    tf_paths = []
    for i in range(3):
        path = tmp_path / f"train-{i:05d}-of-00003.tfrecord"
        treaders.write_tfrecords(path, recs[4 * i:4 * i + 4])
        tf_paths.append(str(path))
    shards = [_token_shard(s, 5 + s)[0] for s in range(3)]
    wds_local = [_write(tmp_path, f"shard-{i}.tar", d) for i, d in enumerate(shards)]
    wds_urls = [gateway.put(f"/wds/shard-{i}.tar", d, f'"s{i}"') for i, d in enumerate(shards)]
    image = np.random.default_rng(5).bytes(300_001)
    gateway.put("/rbd/vol-7", image, '"img"')
    gateway.auth["/rbd/vol-7"] = _auth("alice", "s3cret")
    ceph = dict(monitors=gateway.url, user="alice", secret="s3cret", pool="rbd", image="vol-7")
    tf_bytes = b"".join(open(p, "rb").read() for p in tf_paths)
    return {
        "tfrecord": (dict(paths=tf_paths), tf_bytes),
        "webdataset-local": (dict(shard_urls=wds_local), b"".join(shards)),
        "webdataset-url": (dict(shard_urls=wds_urls), b"".join(shards)),
        "ceph": (ceph, image),
    }


KINDS = ["tfrecord", "webdataset-local", "webdataset-url", "ceph"]


# ---------------------------------------------------------------- readers --


def test_write_tfrecords_is_byte_identical(tmp_path):
    recs = _records(1, 20)
    jreaders.write_tfrecords(tmp_path / "j.tfrecord", recs)
    treaders.write_tfrecords(tmp_path / "t.tfrecord", recs)
    assert (tmp_path / "t.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()


def test_encode_example_is_byte_identical():
    for ex in _examples(2, 8) + [{"x": 3}, {"y": 2.5}, {"z": b""}, {"neg": [-1, -2**63]}]:
        assert treaders.encode_example(ex) == jreaders.encode_example(ex)


def test_parse_example_matches_jax():
    for ex in _examples(3, 8):
        payload = jreaders.encode_example(ex)
        got, want = treaders.parse_example(payload), jreaders.parse_example(payload)
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k]
        assert int(got["image/class/label"][0]) == ex["image/class/label"]
        assert got["image/encoded"] == [ex["image/encoded"]]


def test_iter_tfrecord_bytes_matches_jax(tmp_path):
    recs = _records(4, 30)
    treaders.write_tfrecords(tmp_path / "r.tfrecord", recs)
    data = np.fromfile(tmp_path / "r.tfrecord", np.uint8)
    assert list(treaders.iter_tfrecord_bytes(data)) == list(jreaders.iter_tfrecord_bytes(data))
    assert list(treaders.iter_tfrecord_bytes(data.tobytes())) == recs


@pytest.mark.parametrize("cut", [5, 12 + 3, -2])
def test_iter_tfrecord_bytes_raises_on_a_truncated_tail_as_jax(tmp_path, cut):
    recs = _records(5, 6)
    treaders.write_tfrecords(tmp_path / "r.tfrecord", recs)
    whole = np.fromfile(tmp_path / "r.tfrecord", np.uint8)
    first = 12 + len(recs[0]) + 4
    data = whole[:first + cut] if cut > 0 else whole[:cut]
    with pytest.raises(IOError) as t_err:
        list(treaders.iter_tfrecord_bytes(data))
    with pytest.raises(IOError) as j_err:
        list(jreaders.iter_tfrecord_bytes(data))
    assert str(t_err.value) == str(j_err.value)


def test_complete_tfrecord_prefix_matches_jax_at_every_cut(tmp_path):
    recs = _records(6, 5)
    treaders.write_tfrecords(tmp_path / "r.tfrecord", recs)
    whole = np.fromfile(tmp_path / "r.tfrecord", np.uint8)
    for end in range(0, whole.size + 1, 7):
        assert (treaders.complete_tfrecord_prefix(whole[:end])
                == jreaders.complete_tfrecord_prefix(whole[:end]))
    assert treaders.complete_tfrecord_prefix(whole) == whole.size


def test_read_tfrecord_batch_matches_jax_and_checks_record_bytes(tmp_path):
    rng = np.random.default_rng(7)
    paths = []
    for i in range(3):
        treaders.write_tfrecords(tmp_path / f"{i}.tfrecord", [rng.bytes(64) for _ in range(4)])
        paths.append(str(tmp_path / f"{i}.tfrecord"))
    (tmp_path / "empty.tfrecord").write_bytes(b"")
    paths.insert(1, str(tmp_path / "empty.tfrecord"))
    got = treaders.read_tfrecord_batch(paths, record_bytes=64)
    assert got.dtype == np.uint8
    assert got.tobytes() == jreaders.read_tfrecord_batch(paths, record_bytes=64).tobytes()
    with pytest.raises(ValueError, match="record_bytes 63") as t_err:
        treaders.read_tfrecord_batch(paths, record_bytes=63)
    with pytest.raises(ValueError) as j_err:
        jreaders.read_tfrecord_batch(paths, record_bytes=63)
    assert str(t_err.value) == str(j_err.value)


# ------------------------------------------------------------- webdataset --


def _tar_cases():
    rng = np.random.default_rng(8)
    one = _tar([(f"{i:04d}.{ext}", rng.bytes(int(rng.integers(0, 1500))))
                for i in range(6) for ext in ("jpg", "cls", "seg.png")])
    nested = _tar([("train/", b""), ("train/a.bin", b"x" * 513), ("train/a.txt", b"hi"),
                   ("train/b.bin", b""), ("README", b"no extension")])
    return {"one": one, "nested": nested, "concatenated": one + nested + one}


@pytest.mark.parametrize("case", ["one", "nested", "concatenated"])
def test_index_shard_matches_jax(case):
    data = _tar_cases()[case]
    for shard in (data, np.frombuffer(data, np.uint8)):
        got = twebdataset.index_shard(shard)
        want = jwebdataset.index_shard(shard)
        assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
        assert [(e.key, e.ext) for e in got] == [(e.key, e.ext) for e in want]
    assert got


@pytest.mark.parametrize("case", ["one", "nested", "concatenated"])
def test_iter_samples_matches_jax(case):
    data = _tar_cases()[case]
    shards = [data, np.frombuffer(_tar_cases()["one"], np.uint8)]
    assert list(twebdataset.iter_samples(shards)) == list(jwebdataset.iter_samples(shards))


def test_index_shard_raises_on_a_corrupt_header_as_jax():
    data = bytearray(_tar_cases()["one"])
    data[148:156] = b"garbage!"  # the first header's checksum field
    for mod in (twebdataset, jwebdataset):
        with pytest.raises(tarfile.ReadError):
            mod.index_shard(bytes(data))


def test_read_shards_local_and_url_match_jax(tmp_path, gateway):
    shards = [_token_shard(s, 4)[0] for s in range(3)]
    local = [_write(tmp_path, f"{i}.tar", d) for i, d in enumerate(shards)]
    urls = [gateway.put(f"/b/{i}.tar", d) for i, d in enumerate(shards)]
    mixed = [local[0], urls[1], local[2]]
    for paths, picked in ((local, [0, 1, 2]), (urls, [0, 1, 2]), (mixed, [0, 1, 2]),
                          (urls[1:2], [1]), (local[2:], [2]), ([], [])):
        got = twebdataset.read_shards(paths)
        assert got.dtype == np.uint8
        assert got.tobytes() == jwebdataset.read_shards(paths).tobytes()
        assert got.tobytes() == b"".join(shards[i] for i in picked)
    assert twebdataset.shard_sizes(mixed) == jwebdataset.shard_sizes(mixed) == [
        len(d) for d in shards]


# ------------------------------------------------------------ objectstore --


def test_read_object_and_read_range_match_jax(gateway):
    data = np.random.default_rng(9).bytes(1_000_003)
    url = gateway.put("/bucket/key", data)
    got = tobjectstore.read_object(url, part_bytes=65_536, n_threads=4)
    assert got.tobytes() == data == jobjectstore.read_object(url, part_bytes=65_536).tobytes()
    out = np.zeros(20, np.uint8)
    tobjectstore.read_range(url, 100, 7, out[3:10])
    assert out[3:10].tobytes() == data[100:107] and not out[:3].any() and not out[10:].any()
    for off, n in ((0, 1), (12345, 300_000), (997_000, 3_003)):
        t_out = np.zeros(n, np.uint8)
        j_out = np.zeros(n, np.uint8)
        tobjectstore.read_range(url, off, n, t_out, part_bytes=70_001, expected_total=len(data))
        jobjectstore.read_range(url, off, n, j_out, part_bytes=70_001, expected_total=len(data))
        assert t_out.tobytes() == j_out.tobytes() == data[off:off + n]
    assert tobjectstore.fetch(url, 10, 5) == jobjectstore.fetch(url, 10, 5) == data[10:15]
    assert tobjectstore.content_length(url) == len(data)


def test_object_validators_match_jax(gateway):
    url = gateway.put("/v", b"abc", etag='"e-1"')
    assert tobjectstore.object_validators(url) == jobjectstore.object_validators(url) == (
        '"e-1"', "")


@pytest.mark.parametrize("ranged", [False, True])
def test_an_object_changed_mid_stage_fails_the_read(gateway, ranged):
    data = np.random.default_rng(10).bytes(200_000)
    url = gateway.put("/o", data)
    gateway.put("/o", data + b"more")  # re-uploaded after the size was taken
    with pytest.raises(tobjectstore.ObjectStoreError, match="changed mid-stage"):
        if ranged:
            tobjectstore.read_range(url, 0, 1000, np.zeros(1000, np.uint8),
                                    expected_total=len(data))
        else:
            tobjectstore.read_object(url, out=np.zeros(len(data), np.uint8),
                                     part_bytes=50_000)


def test_basic_auth_and_a_401_that_is_not_retried(gateway):
    url = gateway.put("/secret", b"payload")
    gateway.auth["/secret"] = _auth("bob", "pw")
    with pytest.raises(tobjectstore.ObjectStoreError, match="HTTP 401"):
        tobjectstore.read_object(url, tobjectstore.basic_auth_headers("bob", "wrong"))
    assert len(gateway.requests) == 2  # HEAD, then the 1-byte GET; no retries
    hdrs = tobjectstore.basic_auth_headers("bob", "pw")
    assert hdrs == jobjectstore.basic_auth_headers("bob", "pw")
    assert tobjectstore.basic_auth_headers() == {} == jobjectstore.basic_auth_headers()
    assert tobjectstore.read_object(url, hdrs).tobytes() == b"payload"


def test_content_length_without_head_takes_a_one_byte_range(gateway):
    url = gateway.put("/nohead", b"x" * 777)
    gateway.refuse_head = True
    assert tobjectstore.content_length(url) == jobjectstore.content_length(url) == 777


def test_transient_5xx_is_retried_and_404_is_not(gateway):
    url = gateway.put("/flaky", b"0123456789")
    gateway.fail_next = 2
    assert tobjectstore.fetch(url, 2, 3) == b"234"
    assert gateway.gets() == 3
    n = len(gateway.requests)
    with pytest.raises(tobjectstore.ObjectStoreError, match="HTTP 404"):
        tobjectstore.fetch(gateway.url + "/missing")
    assert len(gateway.requests) == n + 1


@pytest.mark.parametrize("endpoint,segments", [
    ("http://gw:7480", ("pool", "img")), ("gw:7480/", ("/pool/", "img")),
    ("https://gw", ("bucket", "", "a/b")), ("http://gw/", ()),
])
def test_object_url_and_is_url_match_jax(endpoint, segments):
    got = tobjectstore.object_url(endpoint, *segments)
    assert got == jobjectstore.object_url(endpoint, *segments)
    assert tobjectstore.is_url(got) and not tobjectstore.is_url("/data/x.tar")


# ---------------------------------------------------- load_source, lowering --


def test_sources_are_the_jax_tuple():
    assert tsource.SOURCES == jsource.SOURCES


@pytest.mark.parametrize("kind", KINDS)
def test_load_source_matches_jax(sources, kind):
    fields, want = sources[kind]
    jparams, tparams = _params(kind.split("-")[0], **fields)
    got = tsource.load_source(kind.split("-")[0], tparams)
    assert got.dtype == np.uint8
    assert got.tobytes() == want == jsource.load_source(kind.split("-")[0], jparams).tobytes()


@pytest.mark.parametrize("fmt", ["raw", "npy"])
def test_load_source_file_matches_jax(tmp_path, fmt):
    arr = np.arange(24, dtype=np.int16).reshape(4, 6)
    path = tmp_path / "v.npy"
    np.save(path, arr)
    jparams, tparams = _params("file", path=str(path), format=fmt)
    got = tsource.load_source("file", tparams)
    want = jsource.load_source("file", jparams)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_load_source_refuses_ceph_without_a_gateway_as_jax():
    jparams, tparams = _params("ceph", pool="rbd", image="x")
    for fn, params in ((tsource.load_source, tparams), (jsource.load_source, jparams)):
        with pytest.raises(ValueError, match="monitors"):
            fn("ceph", params)
    with pytest.raises(ValueError, match="monitors"):
        tplane.lower_source("ceph", tparams)


@pytest.mark.parametrize("kind", KINDS)
def test_lower_source_matches_jax_field_for_field(sources, kind):
    fields, want = sources[kind]
    jparams, tparams = _params(kind.split("-")[0], **fields)
    got = tplane.lower_source(kind.split("-")[0], tparams)
    ref = jplane.lower_source(kind.split("-")[0], jparams)
    assert [dataclasses.astuple(e) for e in got.extents] == [
        dataclasses.astuple(e) for e in ref.extents]
    assert (got.headers, got.src_dtype, got.src_shape, got.total_bytes) == (
        ref.headers, ref.src_dtype, ref.src_shape, ref.total_bytes)
    assert got.total_bytes == len(want)
    dst = np.zeros(got.total_bytes, np.uint8)
    tplane.read_range(got, 0, dst)
    assert dst.tobytes() == want


# ---------------------------------------------------------------- backends --


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_backend_on_cpu_stages_the_bytes_tpu_backend_stages(sources, kind):
    fields, want = sources[kind]
    jparams, tparams = _params(kind.split("-")[0], **fields)
    calls = tplane.STAGE_CALLS
    vol = _stage(CUDABackend(device="cpu", chunk_bytes=4096), kind.split("-")[0], tparams)
    assert vol.state == StageState.READY, vol.error
    assert tplane.STAGE_CALLS == calls + 1  # the plane, not the whole-read path
    assert _bytes_of(vol.array) == want == _jax_stage(kind.split("-")[0], jparams).tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_malloc_backend_stages_the_bytes_of_jax_malloc_backend(sources, kind):
    fields, want = sources[kind]
    jparams, tparams = _params(kind.split("-")[0], **fields)
    vol = _stage(MallocBackend(), kind.split("-")[0], tparams)
    assert vol.state == StageState.READY, vol.error
    jvol = JStagedVolume("vol", b"", pb.ArraySpec())
    JMallocBackend().stage(jvol, kind.split("-")[0], jparams)
    assert jvol.wait(60) and not jvol.error
    assert _bytes_of(vol.array) == want == np.asarray(jvol.array).tobytes()


def test_a_wrong_ceph_secret_fails_the_volume_with_the_gateway_status(sources):
    fields = dict(sources["ceph"][0], secret="wrong")
    vol = _stage(CUDABackend(device="cpu"), "ceph", tspec.CephParams(**fields))
    assert vol.state == StageState.FAILED and "HTTP 401" in vol.error
    assert vol.array is None


def test_a_missing_shard_url_fails_the_volume_not_the_stage_call(gateway):
    params = tspec.WebDatasetParams((gateway.url + "/nope.tar",))
    vol = StagedVolume("vol", b"", tspec.ArraySpec())
    CUDABackend(device="cpu").stage(vol, "webdataset", params)  # returns at once
    assert vol.wait(60) and vol.state == StageState.FAILED and "HTTP 404" in vol.error


def test_object_fingerprints_match_jax(sources):
    for kind in ("webdataset-url", "ceph"):
        fields, _ = sources[kind]
        jparams, tparams = _params(kind.split("-")[0], **fields)
        got = tstagecache.fingerprint_source(tplane.lower_source(kind.split("-")[0], tparams))
        want = jstagecache.fingerprint_source(jplane.lower_source(kind.split("-")[0], jparams))
        assert got == want and got is not None


def test_an_object_without_validators_is_not_cached(gateway):
    url = gateway.put("/plain.tar", _token_shard(0, 2)[0], etag="")
    src = tplane.lower_source("webdataset", tspec.WebDatasetParams((url,)))
    assert tstagecache.fingerprint_source(src) is None
    assert jstagecache.fingerprint_source(
        jplane.lower_source("webdataset", pb.WebDatasetParams(shard_urls=[url]))) is None


def test_restage_of_an_unchanged_url_shard_hits_and_a_changed_etag_misses(gateway):
    shards = [_token_shard(s, 6)[0] for s in range(2)]
    urls = [gateway.put(f"/c/{i}.tar", d, f'"a{i}"') for i, d in enumerate(shards)]
    params = tspec.WebDatasetParams(tuple(urls))
    backend = CUDABackend(device="cpu", cache_bytes=1 << 24)
    first = _stage(backend, "webdataset", params)
    assert first.state == StageState.READY
    ptr = first.array.data_ptr()
    backend.unstage(first)

    calls, gets = tplane.STAGE_CALLS, gateway.gets()
    hit = _stage(backend, "webdataset", params)
    assert hit.state == StageState.READY and hit.array.data_ptr() == ptr
    assert tplane.STAGE_CALLS == calls and gateway.gets() == gets  # HEADs only
    backend.unstage(hit)

    changed = bytearray(shards[1])
    changed[-2000] ^= 0xFF  # same size, other bytes: only the ETag tells
    gateway.put("/c/1.tar", bytes(changed), '"a1-2"')
    miss = _stage(backend, "webdataset", params)
    assert miss.state == StageState.READY and tplane.STAGE_CALLS == calls + 1
    assert _bytes_of(miss.array) == shards[0] + bytes(changed)
    assert backend.cache.stats()["hits"] == 1
    backend.unstage(miss)


# ------------------------------------------------------------------- feeds --


def test_wds_tokens_matches_jax_and_feeds_token_batches(tmp_path, gateway):
    parts = [_token_shard(s, 9, span=9) for s in range(3)]
    urls = [gateway.put(f"/t/{i}.tar", d) for i, (d, _) in enumerate(parts)]
    vol = _stage(CUDABackend(device="cpu"), "webdataset", tspec.WebDatasetParams(tuple(urls)))
    staged = vol.array.numpy()
    got = tfeeds._wds_tokens(staged)
    want = jfeeds._wds_tokens(staged, "bin", "vol")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.concatenate([t for _, t in parts]))
    assert tfeeds._wds_tokens(staged, "none").size == 0
    with pytest.raises(SystemExit, match="not int32-aligned"):
        tfeeds._wds_tokens(staged, "cls")

    @dataclasses.dataclass
    class Cfg:
        seq_len: int = 8
        batch_size: int = 2

    mine = tfeeds.volume_token_batches(torch.from_numpy(got.copy()), Cfg(), shuffle_seed=3)
    ref = jfeeds._cycle_token_batches(want, Cfg(), "vol", 3)
    for _ in range(20):
        np.testing.assert_array_equal(next(mine)["tokens"].numpy(), next(ref)["tokens"])


def test_the_parts_of_one_object_are_read_in_parallel(gateway, monkeypatch):
    """The ranged reads of one object overlap: a gateway that takes 0.2 s
    a request serves 8 parts in well under 8 x 0.2 s."""
    data = np.random.default_rng(11).bytes(8 * 4096)
    url = gateway.put("/slow", data)
    orig = _Handler.do_GET

    def slow_get(self):
        time.sleep(0.2)
        orig(self)

    monkeypatch.setattr(_Handler, "do_GET", slow_get)
    t0 = time.monotonic()
    got = tobjectstore.read_object(url, part_bytes=4096, n_threads=8)
    took = time.monotonic() - t0
    assert got.tobytes() == data and took < 8 * 0.2 * 0.75
