"""Checkpoint / resume (``oim_tpu/train/checkpoint.py``), torch-native.

The JAX package saves through orbax; this format is NOT interchangeable
with orbax: a checkpoint of one package cannot be restored by the other.
Each step is a directory ``<dir>/<step>/``. A save writes into a
temporary directory beside the final one, fsyncs its files and both
directories, then renames it into place, so a crash never leaves a half
checkpoint that ``latest_step`` would pick; leftover temporary
directories are ignored. A step at or below the latest one on disk (or
the latest this checkpointer saved) is not written again (orbax's manager
skips it too). Tensors keep their dtype, shape and strides (conv kernels
stay channels_last), so a restored state is the saved one byte for byte.

One process writes ``state.pt``: a ``torch.save`` of step, params, extra
and the optimizer's count, mu and nu, loaded back with
``weights_only=True``.

Under a mesh of several ranks (``Layout``) each rank writes the pieces it
holds of params, extra and the moments, as orbax writes a sharded array:
a piece held by several ranks (a replica group) is written by the lowest
of them only. Rank m writes ``piece-<m>.pt`` and ``piece-<m>.json`` (each
leaf's global shape, dtype and its piece's index range), fsyncs them and
then its marker ``done-<m>``. The lowest rank commits: once every rank's
marker is there it writes ``manifest.json`` (the pieces of every leaf)
and renames the directory into place. The write runs in a background
thread and makes no collective on the training process group there (it
would interleave with the step's): the ranks meet through the marker
files. A rank lost between its piece and the commit leaves the previous
step as the latest. The temporary directory's name carries a run id the
ranks agree on when the checkpointer is made, so the files of an earlier
run cut at the same step are never taken for this one's.

``restore`` reads either format into any layout: each rank assembles
the piece its shardings give it, under a mesh of other axes or another
size, or whole on one process, from the pieces that overlap it (the
files are memory-mapped: a rank reads the bytes it needs).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from oim_tpu_torch.train.state import OptState, TrainState

STATE_FILE = "state.pt"
MANIFEST = "manifest.json"
_TMP = ".tmp-"
COMMIT_TIMEOUT = 600.0  # seconds the lowest rank waits for every rank's pieces


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durable(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _leaves(tree, prefix: str):
    """(name, leaf) of a nested dict, names joined by "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _state_leaves(state: TrainState):
    yield from _leaves(state.params, "params")
    yield from _leaves(state.extra, "extra")
    yield from _leaves(state.opt_state.mu, "opt_state/mu")
    yield from _leaves(state.opt_state.nu, "opt_state/nu")


def _nest(flat: dict, section: str) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        top, *path = name.split("/")
        if top == "opt_state":
            top, path = f"{top}/{path[0]}", path[1:]
        if top != section:
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


class Layout:
    """This rank's part of a checkpoint under ``mesh``: the piece of each
    leaf it holds (``shardings``, the params' Sharding tree, None for every
    leaf whole; the moments follow their params, ``extra`` is whole) and
    whether it writes that piece (the lowest rank of the piece's replica
    group: index 0 on every axis of more than one rank that does not split
    the leaf). Making one is collective over the mesh: the ranks agree on
    a run id (``psum`` of the lowest rank's over every axis of more than
    one rank)."""

    def __init__(self, mesh, shardings=None):
        from oim_tpu_torch.parallel.collectives import psum

        self.mesh = mesh
        shape = tuple(mesh.shape.values())
        self.world = mesh.size
        self.member = int(np.ravel_multi_index(mesh.coordinate, shape)) if shape else 0
        self._shardings = dict(_leaves(shardings, "params")) if shardings is not None else {}
        token = int.from_bytes(os.urandom(6), "little") if self.member == 0 else 0
        agreed = psum(torch.tensor(token, dtype=torch.int64, device=mesh.device),
                      [mesh.axis(a) for a, size in mesh.shape.items() if size > 1])
        self.run = f"{int(agreed):012x}"

    def sharding(self, name: str):
        if name.startswith("opt_state/"):
            name = "params/" + name.split("/", 2)[2]
        return self._shardings.get(name)

    def index(self, name: str, shape) -> tuple[tuple[int, int], ...]:
        """This rank's [start, stop) along each dim of the leaf ``name`` of
        global ``shape``."""
        s = self.sharding(name)
        out = []
        for dim, size in enumerate(shape):
            n, i = s.parts(self.mesh, dim) if s is not None and dim < len(s.dims) else (1, 0)
            step = size // n
            out.append((i * step, (i + 1) * step))
        return tuple(out)

    def global_shape(self, name: str, local) -> tuple[int, ...]:
        s = self.sharding(name)
        return tuple(size * (s.parts(self.mesh, d)[0] if s is not None and d < len(s.dims)
                             else 1) for d, size in enumerate(local))

    def writes(self, name: str) -> bool:
        s = self.sharding(name)
        split = s.axes if s is not None else ()
        return all(self.mesh.axis(a).index == 0 for a, size in self.mesh.shape.items()
                   if size > 1 and a not in split)


class _Reader:
    """Leaves of a saved step by name: global shape and ``read(name,
    index)``, the tensor over the [start, stop) ranges of ``index``."""

    def __init__(self, path: str):
        self.path = path
        manifest = os.path.join(path, MANIFEST)
        if os.path.isfile(manifest):
            with open(manifest) as f:
                self.manifest = json.load(f)
            self.step, self.count = self.manifest["step"], self.manifest["count"]
            self.shapes = {n: tuple(v["shape"]) for n, v in self.manifest["leaves"].items()}
            self._files: dict[int, dict] = {}
        else:
            self.manifest = None
            snap = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                              weights_only=True, mmap=True)
            self.step, self.count = snap["step"], snap["opt_state"]["count"]
            self._whole = {}
            for section in ("params", "extra"):
                self._whole.update(_leaves(snap[section], section))
            for section in ("mu", "nu"):
                self._whole.update(_leaves(snap["opt_state"][section], f"opt_state/{section}"))
            self.shapes = {n: tuple(t.shape) for n, t in self._whole.items()}

    def _file(self, member: int) -> dict:
        if member not in self._files:
            self._files[member] = torch.load(os.path.join(self.path, f"piece-{member}.pt"),
                                             map_location="cpu", weights_only=True, mmap=True)
        return self._files[member]

    def read(self, name: str, index) -> torch.Tensor:
        want = tuple(slice(a, b) for a, b in index)
        if self.manifest is None:
            t = self._whole[name]
            return (t if all((a, b) == (0, s) for (a, b), s in zip(index, t.shape))
                    else t[want]).clone(memory_format=torch.preserve_format)
        pieces = self.manifest["leaves"][name]["pieces"]
        out = None
        for piece in pieces:
            have = [tuple(r) for r in piece["index"]]
            lo = [max(a, c) for (a, _), (c, _) in zip(index, have)]
            hi = [min(b, d) for (_, b), (_, d) in zip(index, have)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            t = self._file(piece["member"])[name]
            if [tuple(r) for r in index] == have:  # the very piece: its bytes and strides
                return t.clone(memory_format=torch.preserve_format)
            if out is None:
                shape = tuple(b - a for a, b in index)
                fmt = (torch.channels_last if t.dim() == 4 and not t.is_contiguous()
                       and t.is_contiguous(memory_format=torch.channels_last)
                       else torch.contiguous_format)
                out = torch.empty(shape, dtype=t.dtype).contiguous(memory_format=fmt)
            dst = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, index))
            src = tuple(slice(l - c, h - c) for l, h, (c, _) in zip(lo, hi, have))
            out[dst] = t[src]
        if out is None:
            raise ValueError(f"{self.path}: no saved piece of {name} overlaps {index}")
        return out


class Checkpointer:
    """save(step, state) / latest_step() / restore(step), keeping the
    newest ``max_to_keep`` steps. ``layout`` (``Layout``) places this rank
    under a mesh of several ranks; None, or a mesh of one, is one process."""

    def __init__(self, directory: str, max_to_keep: int = 3, layout: Layout | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.layout = layout if layout is not None and layout.world > 1 else None
        os.makedirs(self.directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._error: Exception | None = None
        self._saved: int | None = None

    def save(self, step: int, state: TrainState, wait: bool = False) -> bool:
        """Snapshot ``state`` to host memory now (the step goes on updating
        the live tensors in place), write it in the background; ``wait``
        blocks until it is on disk (under a mesh: this rank's pieces, and
        on the lowest rank the commit). One save is in flight at a time.
        Returns False, writing nothing, for a step at or below the latest
        one on disk or saved by this checkpointer (every rank of a mesh
        decides alike: each calls save at the same steps)."""
        self.wait_until_finished()
        latest = max((s for s in (self.latest_step(), self._saved) if s is not None),
                     default=None)
        if latest is not None and step <= latest:
            return False
        self._saved = int(step)
        copy = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        if self.layout is None:
            snap = {
                "step": int(step),
                "params": _map(copy, state.params),
                "extra": _map(copy, state.extra),
                "opt_state": {"count": int(state.opt_state.count),
                              "mu": _map(copy, state.opt_state.mu),
                              "nu": _map(copy, state.opt_state.nu)},
            }
            target, args = self._write, (int(step), snap)
        else:
            lay = self.layout
            pieces, info = {}, {}
            for name, t in _state_leaves(state):
                shape = lay.global_shape(name, t.shape)
                if lay.writes(name):
                    pieces[name] = copy(t)
                info[name] = {"shape": list(shape), "dtype": str(t.dtype).split(".")[-1],
                              "index": [list(r) for r in lay.index(name, shape)],
                              "written": lay.writes(name)}
            meta = {"step": int(step), "count": int(state.opt_state.count), "leaves": info}
            target, args = self._write_pieces, (int(step), pieces, meta)
        self._writer = threading.Thread(target=self._guarded, args=(target, args),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        if wait:
            self.wait_until_finished()
        return True

    def _guarded(self, target, args) -> None:
        try:
            target(*args)
        except Exception as err:  # noqa: BLE001 - raised again in the caller's thread
            self._error = err

    def _write(self, step: int, snap: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_durable(os.path.join(tmp, STATE_FILE), lambda f: torch.save(snap, f))
        _fsync_dir(tmp)
        self._commit(tmp, final)

    def _commit(self, tmp: str, final: str) -> None:
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        for stale in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(stale)))

    def _write_pieces(self, step: int, pieces: dict, meta: dict) -> None:
        lay = self.layout
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{lay.run}")
        os.makedirs(tmp, exist_ok=True)
        m = lay.member
        _write_durable(os.path.join(tmp, f"piece-{m}.pt"), lambda f: torch.save(pieces, f))
        _write_durable(os.path.join(tmp, f"piece-{m}.json"),
                       lambda f: f.write(json.dumps(meta).encode()))
        self._mark_done(tmp, m)
        if m == 0:
            self._commit_pieces(step, tmp)

    def _mark_done(self, tmp: str, member: int) -> None:
        """This rank's pieces are durable, their directory entries too: then
        its marker. Once the marker exists the lowest rank may rename the
        directory at any moment; its commit fsyncs the directory, markers
        included, before the rename."""
        _fsync_dir(tmp)
        _write_durable(os.path.join(tmp, f"done-{member}"), lambda f: None)

    def _commit_pieces(self, step: int, tmp: str) -> None:
        """The lowest rank: wait for every rank's marker, write the
        manifest, rename the step into place."""
        world = self.layout.world
        deadline = time.monotonic() + COMMIT_TIMEOUT
        while not all(os.path.exists(os.path.join(tmp, f"done-{m}")) for m in range(world)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"step {step}: not every rank's pieces arrived in "
                                   f"{COMMIT_TIMEOUT} s; the step stays uncommitted")
            time.sleep(0.01)
        leaves: dict = {}
        for m in range(world):
            with open(os.path.join(tmp, f"piece-{m}.json")) as f:
                meta = json.load(f)
            for name, v in meta["leaves"].items():
                entry = leaves.setdefault(name, {"shape": v["shape"], "dtype": v["dtype"],
                                                 "pieces": []})
                if v["written"]:
                    entry["pieces"].append({"member": m, "index": v["index"]})
        manifest = {"format": "pieces", "step": step, "count": meta["count"], "world": world,
                    "run": self.layout.run, "leaves": leaves}
        _write_durable(os.path.join(tmp, MANIFEST), lambda f: f.write(json.dumps(manifest).encode()))
        _fsync_dir(tmp)
        self._commit(tmp, os.path.join(self.directory, str(step)))
        # Earlier runs' uncommitted pieces of steps now behind the latest.
        for name in os.listdir(self.directory):
            left = name[len(_TMP):].split("-")[0]
            if name.startswith(_TMP) and left.isdigit() and int(left) <= step:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Join the save in flight; re-raises its error here."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint save into {self.directory} failed") from err

    def all_steps(self) -> list[int]:
        """Committed steps, oldest first (temporary directories skipped)."""
        def committed(name):
            return any(os.path.isfile(os.path.join(self.directory, name, f))
                       for f in (STATE_FILE, MANIFEST))
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and committed(name))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device="cpu",
                layout: Layout | None = None) -> TrainState:
        """The TrainState saved at ``step`` (default: the latest) on
        ``device``: whole, or with ``layout`` (default this checkpointer's)
        this rank's pieces under its mesh, whatever mesh wrote it;
        FileNotFoundError when there is none."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        layout = layout if layout is not None else self.layout
        path = os.path.join(self.directory, str(step))
        if layout is None and not os.path.isfile(os.path.join(path, MANIFEST)):
            snap = torch.load(os.path.join(path, STATE_FILE), map_location=torch.device(device),
                              weights_only=True)
            opt = snap["opt_state"]
            return TrainState(step=snap["step"], params=snap["params"],
                              opt_state=OptState(count=opt["count"], mu=opt["mu"], nu=opt["nu"]),
                              extra=snap["extra"])
        reader = _Reader(path)
        flat = {}
        for name, shape in reader.shapes.items():
            index = (layout.index(name, shape) if layout is not None
                     else tuple((0, s) for s in shape))
            flat[name] = reader.read(name, index).to(device)
        return TrainState(step=reader.step, params=_nest(flat, "params"),
                          opt_state=OptState(count=reader.count, mu=_nest(flat, "opt_state/mu"),
                                             nu=_nest(flat, "opt_state/nu")),
                          extra=_nest(flat, "extra"))

    def close(self) -> None:
        self.wait_until_finished()
