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

Nothing here imports or builds at module import time; the CPU tests import
this module and never reach a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

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
}
_HEADERS = ("flash_common.cuh", "flash_sm90.cuh")

# Launch counts per kernel, and per kernel and route; chip_smoke.py zeroes
# them around the main path.
LAUNCHES = {name: 0 for name in SOURCES}
ROUTES = {name: {"wgmma": 0, "fma": 0} for name in SOURCES}
WGMMA_HEAD_DIMS = (64, 128)  # the head_dims the tensor-core kernels take

MAX_HEAD_DIM = 128  # kMaxD in flash_common.cuh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # DType in flash_common.cuh

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        for route in ROUTES[name]:
            ROUTES[name][route] = 0


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
    if name not in SOURCES or route not in ("wgmma", "fma"):
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
