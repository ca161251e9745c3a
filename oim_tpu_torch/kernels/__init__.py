"""Hand-written Hopper kernels: their loader and their torch wrappers.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, into ``kernels/build/`` inside the checkout
(listed in ``.gitignore``), one ``nvcc`` per source, all started together.
A library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and never served stale.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises
if the launch returns a CUDA error, and counts its launches in
``LAUNCHES`` (only where it launches). There is no fallback: a tensor the
kernel does not take raises.

Routes. K1 (``flash_fwd``), K2 (``flash_bwd_dkv``) and K3
(``flash_bwd_dq``) each have two kernels in their source: a tensor-core one
("wgmma") and the CUDA-core one of the first port ("fma"). ``fwd_route``
(K1) and ``bwd_route`` (K2, K3) pick one by dtype, head_dim and pointer
alignment alone, before the launch; they are one rule, never a ``try``, so
a failed build or launch still raises. ``ROUTES[name][route]`` counts the
launches each route took, beside ``LAUNCHES[name]``.

The paged-decode kernel (``paged_decode``: the serving steps' attention
over each row's pages, read in place through the page table;
``models/generate.py`` dispatches a CUDA pool to it) has two routes, picked
by ``paged_route``: "mma" (``mma.sync`` tensor cores) for bf16 at head_dim
16, 32, 64 or 128 with 16-byte aligned operands, "fma" (CUDA cores) for
everything else. A call counts one launch set (its split and merge
kernels) in ``LAUNCHES`` and under its route in ``ROUTES``.

Nothing here imports or builds at module import time; the CPU tests import
this module and never reach a build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

# kernel name -> source file; every source also includes flash_common.cuh
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "paged_decode": "paged_decode.cu",
}
FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")  # K1-K3, the kernels with routes
_HEADERS = ("flash_common.cuh", "flash_sm90.cuh")

# Launch counts per kernel, and per kernel and route; chip_smoke.py zeroes
# them around the main path.
LAUNCHES = {name: 0 for name in SOURCES}
ROUTES = {name: {"wgmma": 0, "fma": 0} for name in FLASH}
ROUTES["paged_decode"] = {"mma": 0, "fma": 0}
WGMMA_HEAD_DIMS = (64, 128)  # the head_dims the tensor-core kernels take

MAX_HEAD_DIM = 128  # kMaxD in flash_common.cuh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # DType in flash_common.cuh

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


def _route(q, *others) -> str:
    """The one route rule of K1-K3: "wgmma" (tensor cores) for bf16 with
    head_dim 64 or 128, every data pointer 16-byte aligned (the kernels
    copy 16-byte chunks); "fma" (the CUDA-core kernel) for everything else:
    f32 at any head_dim, bf16 at any other head_dim or off a 16-byte
    boundary. Sequence lengths, batch and head counts never change the
    route: both kernels mask ragged tiles. A pure function of the tensors'
    metadata; it launches nothing."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 for t in (q, *others))):
        return "wgmma"
    return "fma"


def fwd_route(q, k, v) -> str:
    """The kernel a CUDA call of K1 takes (``_route``'s rule)."""
    return _route(q, k, v)


def bwd_route(q, k, v, do) -> str:
    """The kernel a CUDA call of K2 or K3 takes (``_route``'s rule)."""
    return _route(q, k, v, do)


def _count(name: str, route: str) -> None:
    LAUNCHES[name] += 1
    ROUTES[name][route] += 1


def _pick_route(route, q, *others) -> str:
    """``route`` None applies the rule (``_route``); a named route
    (measurements only: chip_smoke.py times the fma kernel beside the
    wgmma one) must be one that can take the call."""
    rule = _route(q, *others)
    if route is None or route == rule:
        return rule
    if route == "fma":
        return route
    raise ValueError(f"route {route!r} does not take {q.dtype} head_dim {q.shape[-1]}")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the Hopper kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (SOURCES[name],) + _HEADERS:
        h.update((_CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, verbose: bool = False) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all at once. Returns seconds per kernel
    built (0.0 for one already on disk). Raises with nvcc's output on a
    failed build. ``verbose`` adds ``-Xptxas -v`` (registers, spills) to
    the output returned in the error or printed."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, out = {}, {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            out[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.monotonic())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def _fn(name: str, symbol: str, argtypes):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_flash_shapes(q, k, v) -> None:
    """Raise unless the three flash kernels take these q/k/v (BTHD, one
    CUDA device, f32 or bf16, head_dim <= 128, kv heads dividing q heads,
    non-empty)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernels need CUDA")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} dtype {t.dtype}: want one of {list(_DTYPES)}, all alike")
        if t.dim() != 4:
            raise ValueError(f"{name} shape {tuple(t.shape)}: want [B, T, H, D]")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not divisible by kv heads {k.shape[2]}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernels take 1..{MAX_HEAD_DIM}")
    if tq == 0 or k.shape[1] == 0 or b == 0:
        raise ValueError("empty sequence or batch")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid's y limit 65535")


def _contig(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _rows_f32(name, t, b, h, tq, device) -> None:
    if t.dtype != torch.float32 or t.shape != (b * h, tq) or t.device != device:
        raise ValueError(f"{name}: want f32 [{b * h}, {tq}] on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def flash_fwd(q, k, v, causal: bool, scale: float, route=None):
    """K1: (out [B,Tq,H,D] in q's dtype, lse [B*H, Tq] f32). The kernel is
    ``fwd_route``'s."""
    check_flash_shapes(q, k, v)
    _contig(q=q, k=k, v=v)
    route = _pick_route(route, q, k, v)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    args = [_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, tq, tk, h, hkv, d,
            float(scale), int(causal)]
    if route == "wgmma":
        fn = _fn("flash_fwd", "oim_flash_fwd_wgmma", [_P] * 5 + [_I] * 6 + [_F, _I, _P])
        err = fn(*args, _stream(q))
    else:
        fn = _fn("flash_fwd", "oim_flash_fwd", [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P])
        err = fn(*args, _DTYPES[q.dtype], _stream(q))
    _check(err, "flash_fwd")
    _count("flash_fwd", route)
    return out, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    check_flash_shapes(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {do.dtype} {tuple(do.shape)} does not match q")
    _contig(q=q, k=k, v=v, do=do)
    b, tq, h, _ = q.shape
    _rows_f32("lse", lse, b, h, tq, q.device)
    _rows_f32("delta", delta, b, h, tq, q.device)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float, route=None):
    """K2: (dk, dv) in k's layout and dtype, summed over each kv head's
    query group. The kernel is ``bwd_route``'s."""
    _bwd_inputs(q, k, v, do, lse, delta)
    route = _pick_route(route, q, k, v, do)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    args = [_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
            b, tq, tk, h, hkv, d, float(scale), int(causal)]
    if route == "wgmma":
        fn = _fn("flash_bwd_dkv", "oim_flash_bwd_dkv_wgmma", [_P] * 8 + [_I] * 6 + [_F, _I, _P])
        err = fn(*args, _stream(q))
    else:
        fn = _fn("flash_bwd_dkv", "oim_flash_bwd_dkv", [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P])
        err = fn(*args, _DTYPES[q.dtype], _stream(q))
    _check(err, "flash_bwd_dkv")
    _count("flash_bwd_dkv", route)
    return dk, dv


def kernel_info(name: str, route: str, head_dim: int) -> dict:
    """What the card gives the kernel of ``name`` on ``route`` ("wgmma" at
    ``head_dim`` 64 or 128, "fma" at bf16): registers per thread, local
    memory bytes per thread (spills), dynamic shared memory per block and
    resident blocks per SM, from the CUDA runtime. Launches nothing."""
    if name not in FLASH or route not in ("wgmma", "fma"):
        raise ValueError(f"no route {route!r} of {name!r}")
    out = (ctypes.c_int * 4)()
    err = _fn(name, f"oim_{name}_info", [_I, _I, _P])(int(route == "wgmma"), head_dim, out)
    _check(err, f"{name} info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float, route=None):
    """K3: dq in q's layout and dtype. The kernel is ``bwd_route``'s."""
    _bwd_inputs(q, k, v, do, lse, delta)
    route = _pick_route(route, q, k, v, do)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    args = [_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
            b, tq, tk, h, hkv, d, float(scale), int(causal)]
    if route == "wgmma":
        fn = _fn("flash_bwd_dq", "oim_flash_bwd_dq_wgmma", [_P] * 7 + [_I] * 6 + [_F, _I, _P])
        err = fn(*args, _stream(q))
    else:
        fn = _fn("flash_bwd_dq", "oim_flash_bwd_dq", [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P])
        err = fn(*args, _DTYPES[q.dtype], _stream(q))
    _check(err, "flash_bwd_dq")
    _count("flash_bwd_dq", route)
    return dq


# The paged-decode kernel's split rule is the host's alone
# (paged_decode_splits): the card reads n_max, tab_len, min_pages and the
# query rows a block takes from the call's arguments.
PAGED_MIN_SPLIT_KEYS = 128  # least keys a split takes
PAGED_MMA_HEAD_DIMS = (16, 32, 64, 128)
PAGED_MMA_ROWS = 16  # query rows a block on "mma": mma.sync's M (kMmaRows)
PAGED_BLOCKS_PER_SM = 8  # blocks the split grid aims at for each SM
PAGED_MAX_SPLIT_PAGES = 4096  # table entries a block keeps in shared memory
_sm_counts: dict[int, int] = {}


class PagedSplit(NamedTuple):
    n_max: int      # the most splits one row's live pages take
    tab_len: int    # the most table entries one split reads
    min_pages: int  # the least pages a split takes
    rc: int         # query rows a block takes


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def paged_route(q, pk, pv) -> str:
    """The kernel a CUDA call of ``paged_decode`` takes: "mma" for bf16 at
    head_dim 16, 32, 64 or 128 with q, pk and pv 16-byte aligned (the
    tensor-core kernel copies 16-byte chunks and loads bf16 pairs), "fma"
    for everything else. A pure function of the tensors' metadata."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in PAGED_MMA_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 for t in (q, pk, pv))):
        return "mma"
    return "fma"


def paged_row_split(live: int, page: int, n_max: int, min_pages: int) -> tuple[int, int]:
    """(splits, keys a split) of a row whose queries see ``live`` keys:
    the rule the card applies to each row (``row_split`` in
    paged_decode.cu), min(n_max, ceil(pages / min_pages)) splits of equal
    page counts, the last holding at least one key."""
    pages = -(-live // page)
    n = min(n_max, -(-pages // min_pages))
    pps = -(-pages // n)
    return -(-pages // pps), pps * page


@functools.lru_cache(maxsize=256)
def paged_decode_splits(b: int, kvh: int, rows: int, n_blocks: int, page: int,
                        sms: int, route: str) -> PagedSplit:
    """The split rule of a paged-decode call of ``rows`` query rows a KV
    head (group x T) on ``route``. A block takes PAGED_MMA_ROWS query rows
    on "mma", 8 on "fma" (4 where the call has no more); n_max gives the
    grid of (row, KV head, row chunk, split) blocks about
    PAGED_BLOCKS_PER_SM blocks an SM, never splits a row finer than
    PAGED_MIN_SPLIT_KEYS keys, and never leaves one split more than
    PAGED_MAX_SPLIT_PAGES pages; tab_len is the longest split
    ``paged_row_split`` makes of any live length."""
    rc = PAGED_MMA_ROWS if route == "mma" else 4 if rows <= 4 else 8
    chunks = -(-rows // rc)
    min_pages = -(-PAGED_MIN_SPLIT_KEYS // page)
    n = -(-(PAGED_BLOCKS_PER_SM * sms) // (b * kvh * chunks))
    n = max(1, min(n, -(-n_blocks // min_pages)), -(-n_blocks // PAGED_MAX_SPLIT_PAGES))
    # A row of up to min_pages pages is one split; a longer row's splits
    # are shorter than min_pages until it takes n splits, and the longest
    # row's are then the longest.
    tab_len = max(paged_row_split(live * page, page, n, min_pages)[1] // page
                  for live in (min(min_pages, n_blocks), n_blocks))
    return PagedSplit(n, tab_len, min_pages, rc)


def check_paged_decode(q, pk, pv, page_tables, pos) -> None:
    """Raise unless the paged-decode kernel takes these operands: q [B, T,
    H, hd], one layer's pool pk/pv [n_pages, page, kvh, hd] in q's dtype
    (f32 or bf16, head_dim <= 128, kvh dividing H), int64 page_tables
    [B, n_blocks] and pos [B], all contiguous on one CUDA device."""
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("page_tables", page_tables),
                    ("pos", pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, the kernel needs q's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, pk {pk.dtype}, pv {pv.dtype}: want one of "
                         f"{list(_DTYPES)}, all alike")
    if q.dim() != 4 or pk.dim() != 4 or pv.shape != pk.shape:
        raise ValueError(f"q {tuple(q.shape)} / pk {tuple(pk.shape)} / pv {tuple(pv.shape)}: "
                         "want [B, T, H, hd] and two [n_pages, page, kvh, hd]")
    b, t, h, d = q.shape
    kvh = pk.shape[2]
    if pk.shape[3] != d or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim q {d}, pool {pk.shape[3]}: the kernel takes 1..{MAX_HEAD_DIM}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"q heads {h} not divisible by kv heads {kvh}")
    if page_tables.dtype != torch.int64 or page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError(f"page_tables {page_tables.dtype} {tuple(page_tables.shape)}: "
                         f"want int64 [{b}, n_blocks]")
    if pos.dtype != torch.int64 or pos.shape != (b,):
        raise ValueError(f"pos {pos.dtype} {tuple(pos.shape)}: want int64 [{b}]")
    if 0 in (b, t, pk.shape[0], pk.shape[1], page_tables.shape[1]):
        raise ValueError("empty batch, query, pool or table")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"batch {b} or kv heads {kvh} exceed the grid's limit 65535")
    if page_tables.shape[1] * pk.shape[1] >= 2 ** 31:
        raise ValueError("a table of 2^31 keys or more")


def paged_decode(q, pk, pv, page_tables, pos):
    """Attention of q [B, T, H, hd] over each row's pages of one layer's
    pool, read in place: ``generate._cache_attention(q, _gather(pk,
    page_tables, S), _gather(pv, page_tables, S), pos)`` with S = n_blocks
    x page, where query t of row b sees positions s <= pos[b] + t. Returns
    [B, T, H, hd] in q's dtype; table entries must name pages of the pool.
    The kernel is ``paged_route``'s."""
    check_paged_decode(q, pk, pv, page_tables, pos)
    route = paged_route(q, pk, pv)
    b, t, h, d = q.shape
    page, kvh = pk.shape[1], pk.shape[2]
    nb = page_tables.shape[1]
    rows = (h // kvh) * t
    split = paged_decode_splits(b, kvh, rows, nb, page, _sm_count(q.device), route)
    part = torch.empty(b * kvh * split.n_max * rows * (d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    args = [_ptr(q), _ptr(pk), _ptr(pv), _ptr(page_tables), _ptr(pos), _ptr(part), _ptr(out),
            b, t, h, kvh, d, page, nb, split.n_max]
    if route == "mma":
        fn = _fn("paged_decode", "oim_paged_decode_mma", [_P] * 7 + [_I] * 11 + [_F, _P])
        err = fn(*args, split.tab_len, split.min_pages, split.rc, float(d ** -0.5), _stream(q))
    else:
        row_bytes = d * q.element_size()
        vec = next(v for v in (16, 8, 4, 2)
                   if row_bytes % v == 0 and pk.data_ptr() % v == 0 and pv.data_ptr() % v == 0)
        fn = _fn("paged_decode", "oim_paged_decode", [_P] * 7 + [_I] * 12 + [_F, _I, _P])
        err = fn(*args, vec, split.tab_len, split.min_pages, split.rc, float(d ** -0.5),
                 _DTYPES[q.dtype], _stream(q))
    _check(err, "paged_decode")
    _count("paged_decode", route)
    return out
