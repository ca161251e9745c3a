"""Remote-object reader (``oim_tpu/data/objectstore.py``): HTTP(S) range
reads into host memory.

The network-volume leg of the sources: a volume is an object behind an
object gateway (Ceph's RGW, an S3-compatible store, any server that honours
``Range``), read with many ranged GETs in flight, each landing in its
slice of one destination. Only the standard library's HTTP client is
used. Auth is HTTP Basic from (user, secret); request signing (SigV4) is
gateway-specific and out of scope.

Transient failures (connection resets, timeouts, 5xx) retry a bounded
number of times; 4xx, DNS and TLS-verification failures raise at once.
An object that changes between sizing and reading (its total size in
``Content-Range`` differs) fails the read with ``ObjectStoreError``.
"""

from __future__ import annotations

import base64
import concurrent.futures as cf
import socket
import ssl
import time
import urllib.error
import urllib.request

import numpy as np

from oim_tpu_torch.common.logging import from_context
from oim_tpu_torch.data import staging


class ObjectStoreError(IOError):
    pass


def basic_auth_headers(user: str = "", secret: str = "") -> dict[str, str]:
    if not user and not secret:
        return {}
    token = base64.b64encode(f"{user}:{secret}".encode()).decode()
    return {"Authorization": f"Basic {token}"}


def _transient_urlerror(e: urllib.error.URLError) -> bool:
    """Connection resets and timeouts are transient; DNS failures and TLS
    verification errors are configuration faults that a retry only
    delays."""
    return not isinstance(e.reason, (socket.gaierror, ssl.SSLError))


def _request(url: str, headers: dict[str, str] | None, method: str = "GET",
             timeout: float = 60.0, retries: int = 3, read_body: bool = True):
    """One HTTP request with bounded retry on transient failures, of the
    connect and of the body read alike (where a transfer spends its
    time): one flaky request must not fail a multi-GB parallel stage.
    Permanent failures (4xx, DNS, TLS verification) raise at once.

    Returns (body bytes or None, response headers)."""
    req = urllib.request.Request(url, headers=headers or {}, method=method)
    delay = 0.2
    for attempt in range(retries + 1):
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read() if read_body else None
                return body, resp.headers
        except urllib.error.HTTPError as e:
            e.close()  # a 5xx burst across parallel parts must not leak fds
            if e.code < 500 or attempt >= retries:
                raise ObjectStoreError(f"{method} {url}: HTTP {e.code} {e.reason}") from e
        except urllib.error.URLError as e:
            if attempt >= retries or not _transient_urlerror(e):
                raise ObjectStoreError(f"{method} {url}: {e.reason}") from e
        except (ConnectionError, TimeoutError, OSError) as e:
            # Dropped mid-read, after a successful connect.
            if attempt >= retries:
                raise ObjectStoreError(f"{method} {url}: {e}") from e
        from_context().warning("retrying object request", url=url.split("?")[0],
                               method=method, attempt=attempt + 1)
        time.sleep(delay)
        delay = min(delay * 2, 2.0)


def object_validators(url: str, headers: dict[str, str] | None = None) -> tuple[str, str]:
    """(ETag, Last-Modified) by HEAD: the freshness validators a content
    cache keys on. A same-size re-upload moves at least one of them on a
    real object store; both empty means the store gives no freshness
    signal and the caller must not cache."""
    _, hdrs = _request(url, headers, method="HEAD", read_body=False)
    return hdrs.get("ETag") or "", hdrs.get("Last-Modified") or ""


def content_length(url: str, headers: dict[str, str] | None = None) -> int:
    """Object size by HEAD (by a 1-byte range GET for servers that refuse
    HEAD)."""
    try:
        _, hdrs = _request(url, headers, method="HEAD", read_body=False)
        size = hdrs.get("Content-Length")
        if size is not None:
            return int(size)
    except ObjectStoreError:
        pass
    h = dict(headers or {})
    h["Range"] = "bytes=0-0"
    _, hdrs = _request(url, h)
    rng = hdrs.get("Content-Range", "")
    if "/" in rng:
        return int(rng.rsplit("/", 1)[1])
    raise ObjectStoreError(f"cannot determine size of {url}")


def fetch(url: str, offset: int | None = None, length: int | None = None,
          headers: dict[str, str] | None = None) -> bytes:
    """GET the object (or a byte range of it)."""
    return _fetch_range(url, offset, length, headers)[0]


def _fetch_range(url: str, offset: int | None, length: int | None,
                 headers: dict[str, str] | None) -> tuple[bytes, int | None]:
    """GET bytes, and the object's total size from Content-Range (None for
    an unranged response): the consistency signal ranged reads get for
    free."""
    h = dict(headers or {})
    if offset is not None:
        end = "" if length is None else str(offset + length - 1)
        h["Range"] = f"bytes={offset}-{end}"
    data, hdrs = _request(url, h)
    rng = hdrs.get("Content-Range", "")
    total = None
    if "/" in rng:
        tail = rng.rsplit("/", 1)[1]
        if tail.isdigit():
            total = int(tail)
    if length is not None and len(data) != length:
        raise ObjectStoreError(
            f"{url}: range [{offset}, +{length}) returned {len(data)} bytes "
            "(server may not honor Range requests)")
    return data, total


def _parallel(pull, parts, n_threads: int) -> None:
    if len(parts) == 1:
        pull(parts[0])
        return
    with cf.ThreadPoolExecutor(max_workers=n_threads) as pool:
        for _ in pool.map(pull, parts):
            pass


def read_object(url: str, headers: dict[str, str] | None = None,
                part_bytes: int = 8 << 20, n_threads: int = 8,
                out: np.ndarray | None = None) -> np.ndarray:
    """Whole object -> uint8 array by parallel range GETs, each part
    writing its slice (nothing is concatenated). ``out``, when given (a
    slice of one buffer holding many objects), sets the size: no HEAD;
    else the object is sized by HEAD into plain host memory (its callers,
    the whole-read staging path, copy it synchronously)."""
    if url.startswith("http://") and (headers or {}).get("Authorization"):
        # Credentials over plaintext are acceptable only inside a trusted
        # fabric.
        from_context().warning("sending credentials over plaintext http",
                               url=url.split("?")[0])
    if out is not None:
        size = out.size
    else:
        size = content_length(url, headers)
        out = staging.alloc_pinned(size, pin=False)
    if size == 0:
        return out
    parts = [(off, min(part_bytes, size - off)) for off in range(0, size, part_bytes)]

    def pull(part):
        off, n = part
        data, total = _fetch_range(url, off, n, headers)
        if total is not None and total != size:
            raise ObjectStoreError(
                f"{url}: object is {total} bytes but destination expects "
                f"{size} (changed mid-stage?)")
        out[off:off + n] = np.frombuffer(data, dtype=np.uint8)

    _parallel(pull, parts, n_threads)
    return out


def read_range(url: str, offset: int, length: int, out: np.ndarray,
               headers: dict[str, str] | None = None, part_bytes: int = 8 << 20,
               n_threads: int = 8, expected_total: int | None = None) -> None:
    """Object bytes [offset, offset+length) into ``out`` by parallel range
    GETs: the ranged twin of ``read_object``, the data plane's reader of
    object extents. The caller's extent map sized the object already:
    pass that size as ``expected_total``, and a Content-Range total that
    disagrees fails the read (the object changed mid-stage)."""
    if length == 0:
        return
    parts = [(off, min(part_bytes, length - off)) for off in range(0, length, part_bytes)]

    def pull(part):
        po, n = part
        data, total = _fetch_range(url, offset + po, n, headers)
        if expected_total is not None and total is not None and total != expected_total:
            raise ObjectStoreError(
                f"{url}: object is {total} bytes but the extent map sized "
                f"it at {expected_total} (changed mid-stage?)")
        out[po:po + n] = np.frombuffer(data, dtype=np.uint8)

    _parallel(pull, parts, n_threads)


def is_url(path: str) -> bool:
    return path.startswith(("http://", "https://"))


def ceph_object(params) -> tuple[str, dict[str, str]]:
    """URL and auth headers of a ceph image (``CephParams``) behind the
    cluster's HTTP object gateway: ``monitors`` names the endpoint,
    ``pool``/``image`` the object, ``user``/``secret`` the credentials."""
    if not params.monitors:
        raise ValueError("ceph source requires monitors=<object-gateway endpoint>")
    return (object_url(params.monitors, params.pool, params.image),
            basic_auth_headers(params.user, params.secret))


def object_url(endpoint: str, *segments: str) -> str:
    """Join a gateway endpoint and object path segments (pool/image,
    bucket/key) into a URL."""
    base = endpoint if is_url(endpoint) else f"http://{endpoint}"
    return "/".join([base.rstrip("/")] + [s.strip("/") for s in segments if s])
