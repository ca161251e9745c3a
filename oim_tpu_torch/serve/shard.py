"""Tensor-parallel serving (``oim_tpu/serve/shard.py``): one logical
replica spans N members.

* **Weights** are Megatron-split: wq/wk/wv and the MLP gate/up
  projections by column (each member holds a contiguous 1/N slice of the
  query AND KV heads, so the GQA grouping survives), wo and the MLP down
  projection by row, everything else (embeddings, norms, lm_head)
  replicated (``COL``, ``ROW``, ``leaf_spec``).
* **KV pages** split with the KV heads (``pool_specs``): every member's
  pool holds its own heads' K/V of every page. Page IDs and page tables
  are plain host integers that every member shares, so no page ever
  crosses members. The only traffic between members is two activation
  sums a layer (``models.generate._reduce``).

The member group. The JAX engine is one process running ``shard_map``
over ``shard`` local devices; the port's engine stays one process too.
Member k holds its weight slice and its KV-head slice of the pool on
``devices[k]``, and runs the forward in a thread of its own (one
persistent thread a member, so CUDA's current device and inference mode
are set once). Every member runs the same function on its slices;
``MemberGroup.allreduce`` is a rendezvous: each member posts its partial,
waits for the others, and sums the partials IN MEMBER ORDER on its own
device, so every member holds the same bits whatever the threads'
timing, and greedy decode stays deterministic. Threads rather than
processes: the members share the scheduler's host state as the JAX
program's devices share it, and no process group is needed (NCCL refuses
two ranks on one card), so ``devices=["cuda:0", "cuda:0"]`` runs a
two-member replica on one card, the counterpart of JAX's fake CPU
devices, and ``["cpu", "cpu"]`` runs it in the tests.

The members' registry leases (``ShardMembers``, gRPC) are in
``serve/members.py``; the engine's ``set_member_watch`` takes any callable
that returns the counts.
"""

from __future__ import annotations

import functools
import queue
import threading
import time

import numpy as np
import torch

# Megatron split of the stacked-L llama leaves: COL leaves slice their
# LAST dim (output features / heads), ROW leaves slice dim 1 (input
# features, after the stacked layer dim 0). Everything else replicates.
COL = frozenset({"wq", "wk", "wv", "w_gate", "w_up"})
ROW = frozenset({"wo", "w_down"})


def leaf_spec(name: str) -> tuple:
    """The PartitionSpec entries of one param leaf by its tree key."""
    if name in COL:
        return (None, None, "tp")
    if name in ROW:
        return (None, "tp", None)
    return ()


def pool_specs() -> dict:
    """Page-pool spec: K/V [L, n_pages, page_tokens, n_kv_heads, hd] split
    on the KV-head axis: pages live whole on every member, each member
    holding its own heads' slice of every page."""
    spec = (None, None, None, "tp", None)
    return {"k": spec, "v": spec}


def member_slice(x, spec: tuple, shard: int, rank: int):
    """Member ``rank``'s piece of ``x`` (a tensor or numpy array) under
    ``spec``: the dims marked "tp" cut into ``shard`` contiguous pieces.
    Raises ValueError where a dim does not divide, and for a rank outside
    the group."""
    if not 0 <= rank < shard:
        raise ValueError(f"rank {rank} outside a group of {shard} members")
    for dim, entry in enumerate(spec):
        if entry != "tp":
            continue
        if x.shape[dim] % shard:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split into "
                             f"{shard} members")
        step = x.shape[dim] // shard
        index = [slice(None)] * x.ndim
        index[dim] = slice(rank * step, (rank + 1) * step)
        x = x[tuple(index)]
    return x


def _leaves(tree, key=None):
    """(leaf name, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    else:
        yield key, tree


def member_params(params, shard: int, rank: int, device=None) -> dict:
    """Member ``rank``'s tree: every leaf cut by ``leaf_spec`` (numpy or
    tensor leaves). With ``device``, each piece is a contiguous tensor of
    its own there (never a view of the full weights)."""
    if isinstance(params, dict):
        return {k: (member_params(v, shard, rank, device) if isinstance(v, dict)
                    else _piece(v, leaf_spec(k), shard, rank, device))
                for k, v in params.items()}
    raise TypeError("params must be a dict tree")


def _piece(leaf, spec, shard, rank, device):
    part = member_slice(leaf, spec, shard, rank)
    if device is None:
        return part
    return torch.as_tensor(part).to(device=device, memory_format=torch.contiguous_format,
                                    copy=True)


def member_weight_bytes(params, shard: int) -> int:
    """Bytes of params ONE member holds: split leaves contribute 1/shard
    of their bytes, replicated leaves their full size (the weight half of
    the per-member memory budget)."""
    total = 0
    for name, leaf in _leaves(params):
        nbytes = (leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
                  else int(np.asarray(leaf).nbytes))
        if name in COL | ROW:
            nbytes //= shard
        total += nbytes
    return total


def check_member_budget(params, shard: int, pool_bytes: int, budget: int) -> int:
    """Enforce the per-member memory budget: weights slice + this member's
    pool slice must fit in ``budget`` bytes. Returns the per-member total;
    raises ValueError when it does not fit (refused at shard=1, serves at
    shard=2)."""
    per_member = member_weight_bytes(params, shard) + pool_bytes // shard
    if budget and per_member > budget:
        raise ValueError(
            f"model needs {per_member} bytes per member at shard={shard} "
            f"(weights {member_weight_bytes(params, shard)} + pool "
            f"{pool_bytes // shard}), over the {budget}-byte member HBM "
            f"budget — shard wider")
    return per_member


def _indexed(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def member_devices(shard: int, devices=None) -> tuple:
    """The members' devices: ``devices`` as given (one per member; a
    device may repeat), else the first ``shard`` CUDA devices."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < shard:
            raise ValueError(
                f"shard={shard} needs {shard} CUDA devices, have {have} "
                f"(pass devices=[...] to place members, e.g. two on one card)")
        devices = [f"cuda:{i}" for i in range(shard)]
    devices = tuple(_indexed(torch.device(d)) for d in devices)
    if len(devices) != shard:
        raise ValueError(f"shard={shard} needs {shard} member devices, got {len(devices)}")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"member device {d} requested but no CUDA device is available")
    return devices


class MemberGroup:
    """The members of one sharded replica: a thread a member, each on its
    device, and the rendezvous that sums their partials."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        self._barrier = threading.Barrier(self.size)
        self._parts: list = [None] * self.size
        self._local = threading.local()
        self._run_lock = threading.Lock()
        self._jobs = [queue.SimpleQueue() for _ in range(self.size)]
        for k in range(self.size):
            threading.Thread(target=self._serve, args=(k,), daemon=True,
                             name=f"oim-shard-member-{k}").start()

    def _serve(self, k: int) -> None:
        dev = self.devices[k]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        self._local.rank = k
        with torch.inference_mode():
            while True:
                fn, box, done = self._jobs[k].get()
                try:
                    box[k] = (True, fn(k))
                except BaseException as err:  # noqa: BLE001 - handed to run()
                    box[k] = (False, err)
                    self._barrier.abort()  # frees members waiting on this one
                finally:
                    done.release()

    def run(self, fn) -> list:
        """``fn(k)`` in member k's thread for every member, at once; the
        results in member order. A member's exception is raised here
        (the others are released from the rendezvous first)."""
        with self._run_lock:
            box: list = [None] * self.size
            done = threading.Semaphore(0)
            for q in self._jobs:
                q.put((fn, box, done))
            for _ in range(self.size):
                done.acquire()
            if self._barrier.broken:
                self._barrier.reset()
            errors = [v for ok, v in box if not ok]
            if errors:
                first = next((e for e in errors
                              if not isinstance(e, threading.BrokenBarrierError)), errors[0])
                raise first
            return [v for _, v in box]

    @property
    def rank(self) -> int:
        """The calling member's index (inside ``run`` only)."""
        try:
            return self._local.rank
        except AttributeError:
            raise RuntimeError("allreduce outside a member thread of the group") from None

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every member's ``x``, in member order, on the calling
        member's device (called by every member, inside ``run``)."""
        k = self.rank
        self._parts[k] = x
        self._barrier.wait()
        dev = self.devices[k]
        out = self._parts[0].to(dev)
        for part in self._parts[1:]:
            out = out + part.to(dev)
        self._barrier.wait()  # every member read the parts: the slots are free
        self._parts[k] = None
        return out


@functools.lru_cache(maxsize=8)
def member_group(devices: tuple) -> MemberGroup:
    """The group over ``devices`` (``member_devices``), shared by every
    engine of that placement, as the JAX package caches its ``tp`` mesh."""
    return MemberGroup(devices)


def _place(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def wrap_forward(group: MemberGroup, body, cache_arg: int):
    """A ``(params, *rest) -> (out, cache)`` forward run by every member:
    ``params`` is the list of member trees (``member_params``), the cache
    at ``rest[cache_arg]`` the list of member pools, every other operand
    replicated onto each member's device. ``body`` runs the member-local
    view (``generate.shard_config``'s cfg, ``axis=group``). Returns member
    0's output and the list of pools."""

    def wrapped(params, *rest):
        def member(k):
            dev = group.devices[k]
            args = [rest[i][k] if i == cache_arg else _place(r, dev)
                    for i, r in enumerate(rest)]
            return body(params[k], *args)[0]

        return group.run(member)[0], rest[cache_arg]

    return wrapped


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_allreduce(group: MemberGroup) -> float:
    """Seconds for one 1 KiB allreduce over the group (observed into
    ``oim_serve_ici_allreduce_seconds`` once per target dispatch: the
    per-layer sums inside the step cannot be timed one by one)."""
    xs = [torch.zeros(256, dtype=torch.float32, device=d) for d in group.devices]

    def member(k):
        out = group.allreduce(xs[k])
        _sync(group.devices[k])
        return out

    t0 = time.perf_counter()
    group.run(member)
    return time.perf_counter() - t0


def pool_page_kv(pools: list, page: int, read) -> tuple[np.ndarray, np.ndarray]:
    """One physical page's (k, v) assembled from every member's pool
    (``read`` is ``kvtier.page_kv``), the KV heads in member order: the
    host tier keeps whole pages at any shard count."""
    parts = [read(pool, page) for pool in pools]
    return (np.concatenate([p[0] for p in parts], axis=2),
            np.concatenate([p[1] for p in parts], axis=2))


def stage_pool_page(pools: list, page: int, k: np.ndarray, v: np.ndarray, write) -> list:
    """Write a whole page's (k, v) back, each member its KV heads
    (``write`` is ``kvtier.stage_page``)."""
    n = len(pools)
    for rank, pool in enumerate(pools):
        write(pool, page, member_slice(k, (None, None, "tp"), n, rank),
              member_slice(v, (None, None, "tp"), n, rank))
    return pools


def stage_pool_pages(pools: list, pages: list, ks: list, vs: list, write) -> list:
    """Write whole pages' (k, v) blocks back in one batch a member, each
    member its KV heads (``write`` is ``kvtier.stage_pages``)."""
    n = len(pools)
    spec = (None, None, "tp")
    for rank, pool in enumerate(pools):
        write(pool, pages, [member_slice(k, spec, n, rank) for k in ks],
              [member_slice(v, spec, n, rank) for v in vs])
    return pools
