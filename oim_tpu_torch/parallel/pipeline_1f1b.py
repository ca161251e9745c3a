"""1F1B pipeline schedule (``oim_tpu/parallel/pipeline_1f1b.py``): live
activations bounded by the pipe depth P, not the microbatch count M.

GPipe (``parallel/pipeline.py``) keeps every microbatch's stage graph
until the backward: memory O(M) a stage. 1F1B (PipeDream-flush) runs each
microbatch's backward as soon as its forward has left the pipe, so a stage
holds at most its in-flight window of stashed stage INPUTS and recomputes
the stage forward from the stash in the backward (activation remat):
memory O(P), one extra forward a microbatch.

The schedule is the JAX package's, copied as numpy: ``simulate_1f1b``
walks each device's canonical action order (``_device_order``) tick by
tick, derives the arrivals and the stash depths, and ``validate_schedule``
proves the dependency order, the in-flight bound and slot reuse. v > 1 is
Megatron's interleaved schedule: each rank runs v chunks of L/(P*v)
layers, global stage c*P + d on rank d, bubble (P-1)/(v*M+P-1).

The executor (``pipeline_1f1b_value_and_grad``) is the port's own. Where
the JAX package runs one SPMD program whose ticks are a ``lax.scan`` with
``cond``s, each rank here walks its own column of the same tables and
skips its idle ticks: the ranks of one stage (across ``data`` and ``seq``)
walk the same column, so collectives inside a stage (ring or Ulysses
attention over ``seq``) still pair up. Each tick is:

1. arrivals: what the previous tick's hand-off delivered goes into the
   input stash (activations) or the cotangent stash;
2. forward (no graph): the stage on its stashed input; the last global
   stage keeps its output for the head, any other hands it on;
3. head (every rank of the axis, on the tick the last global stage
   backwards microbatch j): the last stage's output for j is broadcast
   over the axis (a psum with zeros from the others), ``head_fn`` runs
   on every rank with its collectives (the vocab-parallel CE) and is
   differentiated there, seeded with the microbatch's weight;
4. backward: the stage recomputed from the stash with a graph and
   differentiated, seeded with the head's cotangent (last stage) or the
   stashed one (and the aux seed), its parameter gradients summed in f32;
5. hand-off: activations to the right, cotangents to the left, as
   point-to-point pairs (``collectives.send_recv``) posted together, each
   send matched by its peer's receive in the same tick.

Autograd never crosses a process: every cross-rank edge of the graph is a
tensor handed over by hand and its cotangent handed back. Global stage
0's inputs come from the ``Feed`` at the tick it runs their forward, and
their cotangents go back to it at the tick it makes them. ``STASH_PEAK`` records the most live
stash entries of one chunk the last call held, which ``validate_schedule``
bounds by ``stash_x``/``stash_dh``; a write into a live slot (the ring
buffer of depth ``stash_x`` the JAX kernel uses) raises.

Interleaving keeps the storage canonical (rank d its L/P contiguous
layers, as PIPE_RULES shards them): ``to_schedule_layout`` sends each
layer chunk to the rank whose schedule runs it
(``interleave_layer_permutation``) and ``from_schedule_layout`` sends the
gradients back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.mesh import Axis
from oim_tpu_torch.parallel.pipeline import (
    TAG_BWD,
    TAG_FWD,
    Feed,
    Grads,
    Head,
    PipeResult,
    add_aux,
    broadcast_from,
    stage_backward,
)



@dataclasses.dataclass(frozen=True)
class Schedule1F1B:
    """Static 1F1B schedule for (P devices, M microbatches, v virtual
    stages per device — v=1 is classic PipeDream-flush, v>1 the
    Megatron-style interleaved schedule whose bubble is
    (P-1)/(v*M+P-1), v times smaller).

    Global stage s = chunk*P + device. Per-device arrays are
    [n_ticks, P] of microbatch indices (-1 = idle) with companion CHUNK
    arrays (always 0 at v=1):
    - fwd/fwd_c[t, d]: microbatch/chunk device d forwards at tick t
    - bwd/bwd_c[t, d]: microbatch/chunk device d backwards at tick t
    - arr_f/arr_f_c[t, d]: microbatch/chunk whose ACTIVATION arrives at
      d this tick (sent by d-1 at t-1; the ring wrap P-1 -> 0 carries
      chunk c outputs to chunk c+1 inputs); written into the input
      stash on arrival.
    - arr_b/arr_b_c[t, d]: microbatch/chunk whose COTANGENT arrives.
    - inject[t]: microbatch injected from x at device 0 chunk 0 (-1).
    - bank[t]: microbatch whose d_x banks (device 0 chunk 0 B) (-1).
    - head[t]: microbatch in the head phase (device P-1 chunk v-1 B).
    - stash_x / stash_dh: PER-CHUNK ring-buffer depths proven
      collision-free (total slots = v * depth).
    """

    p: int
    m: int
    v: int
    fwd: np.ndarray
    bwd: np.ndarray
    fwd_c: np.ndarray
    bwd_c: np.ndarray
    arr_f: np.ndarray
    arr_b: np.ndarray
    arr_f_c: np.ndarray
    arr_b_c: np.ndarray
    inject: np.ndarray
    bank: np.ndarray
    head: np.ndarray
    stash_x: int
    stash_dh: int

    @property
    def n_ticks(self) -> int:
        return self.fwd.shape[0]


def _device_order(p: int, m: int, v: int, d: int):
    """Canonical action order for device d: [("F"|"B", chunk, mb), ...].

    v=1: classic 1F1B — warmup P-1-d forwards, then (F, B) pairs, then
    trailing backwards (minimal in-flight = min(M, P-d)).
    v>1: Megatron interleaved — F order is chunk-major within groups of
    P microbatches; B order reverse-chunk-major; warmup
    2(P-1-d) + (v-1)P forwards then strict F/B alternation (the 2x and
    the (v-1)P term are what keep the chunk rotation deadlock-free; the
    extra in-flight window is interleaving's memory tax)."""
    total = v * m
    if v == 1:
        w = min(m, p - 1 - d)
        order = [("F", 0, j) for j in range(w)]
        for j in range(m - w):
            order.append(("F", 0, w + j))
            order.append(("B", 0, j))
        order.extend(("B", 0, j) for j in range(m - w, m))
        return order

    def f_action(n):
        g, r = divmod(n, p * v)
        chunk, pos = divmod(r, p)
        return ("F", chunk, g * p + pos)

    def b_action(n):
        g, r = divmod(n, p * v)
        chunk, pos = divmod(r, p)
        return ("B", v - 1 - chunk, g * p + pos)

    warmup = min((p - d - 1) * 2 + (v - 1) * p, total)
    order = [f_action(n) for n in range(warmup)]
    nf, nb = warmup, 0
    while nf < total or nb < total:
        if nf < total:
            order.append(f_action(nf))
            nf += 1
        if nb < total:
            order.append(b_action(nb))
            nb += 1
    return order


def simulate_1f1b(p: int, m: int, v: int = 1) -> Schedule1F1B:
    """Greedy per-device simulation of (interleaved) 1F1B.

    Each device follows its canonical action order (``_device_order``);
    an action runs at the first tick its dependency (upstream F /
    downstream B over GLOBAL stages s = chunk*P + device, completed at
    an earlier tick) is satisfied. One action per device per tick (F and
    B cost one tick each). Interleaving requires M % P == 0 (Megatron's
    grouping)."""
    if p < 1 or m < 1 or v < 1:
        raise ValueError(f"need p, m, v >= 1, got {p}, {m}, {v}")
    if v > 1 and m % p:
        raise ValueError(
            f"interleaved 1F1B groups microbatches by the pipe size: "
            f"M={m} must divide by P={p}"
        )
    s_total = v * p
    orders = [_device_order(p, m, v, d) for d in range(p)]
    done_f = {}  # (global stage, mb) -> completion tick
    done_b = {}
    cursor = [0] * p
    fc_rows, fm_rows, bc_rows, bm_rows = [], [], [], []
    t = 0
    while any(cursor[d] < len(orders[d]) for d in range(p)):
        if t > 8 * (v * m + p) + 64:
            raise AssertionError("1F1B simulation did not converge")
        fc = [-1] * p
        fm = [-1] * p
        bc = [-1] * p
        bm = [-1] * p
        for d in range(p):
            if cursor[d] >= len(orders[d]):
                continue
            kind, c, j = orders[d][cursor[d]]
            s = c * p + d
            if kind == "F":
                ready = s == 0 or done_f.get((s - 1, j), t) < t
                if ready:
                    fc[d], fm[d] = c, j
                    done_f[(s, j)] = t
                    cursor[d] += 1
            else:
                ready = s == s_total - 1 or done_b.get((s + 1, j), t) < t
                if ready:
                    bc[d], bm[d] = c, j
                    done_b[(s, j)] = t
                    cursor[d] += 1
        fc_rows.append(fc)
        fm_rows.append(fm)
        bc_rows.append(bc)
        bm_rows.append(bm)
        t += 1

    fwd = np.asarray(fm_rows, np.int32)
    bwd = np.asarray(bm_rows, np.int32)
    fwd_c = np.asarray(fc_rows, np.int32)
    bwd_c = np.asarray(bc_rows, np.int32)
    n_ticks = fwd.shape[0]

    # Arrivals: device d-1's F output at t-1 lands at d at t; the ring
    # wrap P-1 -> 0 advances the chunk (c outputs feed chunk c+1 inputs;
    # the LAST global stage's output is discarded — the head consumes
    # it). Reverse for cotangents, with the 0 -> P-1 wrap retreating the
    # chunk (chunk 0's d_x banks instead of wrapping).
    arr_f = np.full_like(fwd, -1)
    arr_b = np.full_like(bwd, -1)
    arr_f_c = np.full_like(fwd, -1)
    arr_b_c = np.full_like(bwd, -1)
    for t_ in range(1, n_ticks):
        for d in range(p):
            src = (d - 1) % p
            j, c = fwd[t_ - 1, src], fwd_c[t_ - 1, src]
            if j >= 0:
                cc = c if d > 0 else c + 1
                if cc < v:
                    arr_f[t_, d] = j
                    arr_f_c[t_, d] = cc
            srcb = (d + 1) % p
            jb, cb = bwd[t_ - 1, srcb], bwd_c[t_ - 1, srcb]
            if jb >= 0:
                cc = cb if d < p - 1 else cb - 1
                if cc >= 0:
                    arr_b[t_, d] = jb
                    arr_b_c[t_, d] = cc
    inject = np.where(fwd_c[:, 0] == 0, fwd[:, 0], -1).astype(np.int32)
    bank = np.where(bwd_c[:, 0] == 0, bwd[:, 0], -1).astype(np.int32)
    head = np.where(
        bwd_c[:, -1] == v - 1, bwd[:, -1], -1).astype(np.int32)

    def min_safe_depth(write_tick, release_tick) -> int:
        """Smallest PER-CHUNK ring depth where no two microbatches with
        the same (chunk, slot) have overlapping [write, release]
        lifetimes, any device."""
        for depth in range(1, m + 1):
            ok = True
            for s in range(s_total):
                spans = {}
                for j in range(m):
                    w = write_tick(s, j)
                    r = release_tick(s, j)
                    if w is None:
                        continue
                    spans.setdefault(j % depth, []).append((w, r))
                for slot_spans in spans.values():
                    slot_spans.sort()
                    for (w1, r1), (w2, _) in zip(slot_spans, slot_spans[1:]):
                        if w2 <= r1:
                            ok = False
            if ok:
                return depth
        return m

    stash_x = min_safe_depth(
        # Written at arrival (or injection at F-time for global stage
        # 0); the stash is also the recompute source, so it lives until
        # this stage's B.
        lambda s, j: done_f[(s, j)] if s == 0 else done_f[(s - 1, j)] + 1,
        lambda s, j: done_b[(s, j)],
    )
    stash_dh = min_safe_depth(
        # The last global stage never stashes a cotangent (its backward
        # seeds straight from the head phase at B time).
        lambda s, j: (None if s == s_total - 1
                      else done_b[(s + 1, j)] + 1),
        lambda s, j: done_b[(s, j)],
    )

    sched = Schedule1F1B(
        p, m, v, fwd, bwd, fwd_c, bwd_c, arr_f, arr_b, arr_f_c, arr_b_c,
        inject, bank, head, stash_x, stash_dh)
    validate_schedule(sched)
    return sched


def validate_schedule(sched: Schedule1F1B) -> None:
    """Invariants the executor relies on; raises on violation (run by
    every ``simulate_1f1b``, so a broken schedule never runs)."""
    p, m, v = sched.p, sched.m, sched.v
    s_total = v * p
    f_tick = {}
    b_tick = {}
    for t in range(sched.n_ticks):
        for d in range(p):
            if sched.fwd[t, d] >= 0:
                s = int(sched.fwd_c[t, d]) * p + d
                key = (s, int(sched.fwd[t, d]))
                assert key not in f_tick, ("duplicate F", key)
                f_tick[key] = t
            if sched.bwd[t, d] >= 0:
                s = int(sched.bwd_c[t, d]) * p + d
                key = (s, int(sched.bwd[t, d]))
                assert key not in b_tick, ("duplicate B", key)
                b_tick[key] = t
    for s in range(s_total):
        for j in range(m):
            assert (s, j) in f_tick and (s, j) in b_tick, (s, j)
            if s > 0:
                assert f_tick[(s - 1, j)] < f_tick[(s, j)], "F dependency"
            if s < s_total - 1:
                assert b_tick[(s + 1, j)] < b_tick[(s, j)], "B dependency"
            assert f_tick[(s, j)] <= b_tick[(s, j)], "B before F"
    # THE 1F1B property: in-flight (forwarded, not yet backwarded)
    # microbatch-chunks per DEVICE stay bounded by the warmup window +1
    # — O(P + vP), never O(vM). At v=1 the bound is the classic
    # min(M, P - d).
    for d in range(p):
        live = 0
        peak = 0
        for t in range(sched.n_ticks):
            if sched.fwd[t, d] >= 0:
                live += 1
            if sched.bwd[t, d] >= 0:
                live -= 1
            peak = max(peak, live)
        if v == 1:
            assert peak <= min(m, p - d), (d, peak)
        else:
            assert peak <= min(
                v * m, (p - d - 1) * 2 + (v - 1) * p + 1) + 1, (d, peak)
    # v=1 keeps the classic tight bound (stash depth never exceeds the
    # pipe depth); interleaving's warmup window legitimately needs up to
    # ~2P per chunk.
    assert sched.stash_x <= min(m, p if v == 1 else 2 * p)



def interleave_layer_permutation(n_layers: int, p: int, v: int):
    """Global [L] layer-stack order for interleaved 1F1B: device-major
    chunks, so the contiguous [L/P] shard of rank d is exactly
    its v chunks (chunk c = GLOBAL stage c*P+d) back to back. Returns
    (perm, inv): ``stack[perm]`` is the schedule layout, ``grads[inv]``
    restores canonical layer order."""
    if n_layers % (p * v):
        raise ValueError(
            f"{n_layers} layers not divisible by pipe {p} x virtual {v}")
    lc = n_layers // (p * v)
    perm = []
    for d in range(p):
        for c in range(v):
            s = c * p + d
            perm.extend(range(s * lc, (s + 1) * lc))
    perm = np.asarray(perm, np.int32)
    return perm, np.argsort(perm).astype(np.int32)



# ------------------------------------------------------------ executor ----

# The most live entries of one chunk's input and cotangent stashes in the
# last call, on this rank (bounded by the schedule's stash_x / stash_dh).
STASH_PEAK = {"x": 0, "dh": 0}


class _Stash:
    """Entries (chunk, microbatch) -> tensor, in the ring-buffer slots of
    the JAX kernel (chunk, microbatch % depth): a write into a live slot
    raises, and ``peak`` is the most live entries of one chunk."""

    def __init__(self, depth: int, what: str):
        self.depth, self.what, self.live, self.peak = depth, what, {}, 0

    def put(self, chunk: int, j: int, x) -> None:
        slot = (chunk, j % self.depth)
        if slot in self.live:
            raise AssertionError(f"{self.what} stash slot {slot} of microbatch "
                                 f"{self.live[slot][0]} overwritten by {j}")
        self.live[slot] = (j, x)
        self.peak = max(self.peak, sum(1 for c, _ in self.live if c == chunk))

    def get(self, chunk: int, j: int):
        got, x = self.live[(chunk, j % self.depth)]
        if got != j:
            raise AssertionError(f"{self.what} stash slot holds microbatch {got}, not {j}")
        return x

    def pop(self, chunk: int, j: int):
        x = self.get(chunk, j)
        del self.live[(chunk, j % self.depth)]
        return x


def pipeline_1f1b_value_and_grad(stage_fn, head_fn, chunk_params: list, head_params: list,
                                 feed: Feed, weights, axis: Axis,
                                 aux_seed: torch.Tensor | None = None) -> PipeResult:
    """1F1B (v = len(chunk_params) chunks a rank; v > 1 interleaved) over
    ``axis`` on this rank's stages; returns a ``PipeResult`` with the
    gradients of sum_j w_j * head_j + aux_seed . sum(aux).

    stage_fn(h, c) -> (out, aux): chunk c's layers on h (global stage
        c*P + d); chunk_params[c] are the tensors it differentiates.
    head_fn, head_params, feed, weights, aux_seed: as in GPipe's
        ``pipeline_value_and_grad``.

    Requires M % P == 0 (the JAX kernel's restriction; v > 1 needs it for
    its grouping)."""
    p, d, m, v = axis.size, axis.index, feed.n, len(chunk_params)
    if m % p:
        raise ValueError(
            f"1F1B shards the microbatch dim over the pipe axis: "
            f"n_microbatches {m} must divide by pipe size {p}")
    sched = simulate_1f1b(p, m, v)
    like = feed.like
    shape, dtype, device = tuple(like.shape), like.dtype, like.device
    stash_x = _Stash(sched.stash_x, "input")
    stash_dh = _Stash(sched.stash_dh, "cotangent")
    stash_y: dict = {}  # the last global stage's outputs, for the head
    head = Head(head_fn, head_params, weights, True)
    grads = [Grads(ps) for ps in chunk_params]
    aux_total = None
    recv_y = recv_dh = None
    for t in range(sched.n_ticks):
        # Arrivals: the previous tick's hand-offs.
        if sched.arr_f[t, d] >= 0:
            stash_x.put(int(sched.arr_f_c[t, d]), int(sched.arr_f[t, d]), recv_y)
        if sched.arr_b[t, d] >= 0:
            stash_dh.put(int(sched.arr_b_c[t, d]), int(sched.arr_b[t, d]), recv_dh)

        # Forward, no graph: the backward recomputes it from the stash.
        # Global stage 0 (rank 0's chunk 0) reads or makes a microbatch's
        # input now: every rank calls the feed, which may take collectives.
        j0 = int(sched.fwd[t, 0]) if sched.fwd_c[t, 0] == 0 else -1
        x = feed.take(j0) if j0 >= 0 else None
        y_send = None
        j, c = int(sched.fwd[t, d]), int(sched.fwd_c[t, d])
        if j >= 0:
            if d == 0 and c == 0:
                stash_x.put(0, j, x.detach())
            with torch.no_grad():
                y, _ = stage_fn(stash_x.get(c, j), c)
            if d == p - 1 and c == v - 1:
                stash_y[j] = y
            else:
                y_send = y

        # The head of the microbatch the last global stage backwards now.
        dh_head = None
        jl = int(sched.head[t])
        if jl >= 0:
            last = stash_y.pop(jl) if d == p - 1 else None
            dh_head = head(broadcast_from(last, axis, p - 1, like), jl)

        # Backward: recompute from the stash, seeded from the head or the
        # stashed cotangent.
        dx_send = d_in = None
        j, c = int(sched.bwd[t, d]), int(sched.bwd_c[t, d])
        if j >= 0:
            h = stash_x.pop(c, j).requires_grad_(True)
            dh = dh_head if (d == p - 1 and c == v - 1) else stash_dh.pop(c, j)
            out, aux = stage_fn(h, c)
            d_in, d_params, aux = stage_backward(h, out, aux, chunk_params[c], dh, aux_seed)
            grads[c].add(d_params)
            aux_total = add_aux(aux_total, aux)
            if d or c:
                dx_send = d_in
        # Global stage 0 made a microbatch's cotangent now: every rank
        # gives it to the feed, rank 0 the tensor.
        j0 = int(sched.bwd[t, 0]) if sched.bwd_c[t, 0] == 0 else -1
        if j0 >= 0:
            feed.give(j0, d_in if d == 0 else None)

        # Hand-offs, received as the next tick's arrivals.
        sends, recvs = [], []
        if y_send is not None:
            sends.append((y_send, (d + 1) % p, TAG_FWD))
        if dx_send is not None:
            sends.append((dx_send, (d - 1) % p, TAG_BWD))
        nxt = t + 1 < sched.n_ticks
        if nxt and sched.arr_f[t + 1, d] >= 0:
            recvs.append((shape, dtype, (d - 1) % p, TAG_FWD))
        if nxt and sched.arr_b[t + 1, d] >= 0:
            recvs.append((shape, dtype, (d + 1) % p, TAG_BWD))
        got = iter(collectives.send_recv(axis, sends, recvs, device))
        recv_y = next(got) if nxt and sched.arr_f[t + 1, d] >= 0 else None
        recv_dh = next(got) if nxt and sched.arr_b[t + 1, d] >= 0 else None
    if stash_x.live or stash_dh.live or stash_y:
        raise AssertionError("1F1B ended with live stash entries")
    STASH_PEAK["x"], STASH_PEAK["dh"] = stash_x.peak, stash_dh.peak
    return PipeResult(head.loss, aux_total, head.extra, [g.result() for g in grads],
                      head.grads.result())


# ---------------------------------------------------- interleaved layout ----


def _chunk_moves(n_layers: int, axis: Axis, v: int):
    """For each global chunk of L/(P*v) layers: (its global id, the rank
    holding it canonically and its chunk index there, the rank running it
    and its chunk index in that rank's schedule layout)."""
    p = axis.size
    perm, _ = interleave_layer_permutation(n_layers, p, v)
    per, lc = n_layers // p, n_layers // (p * v)
    moves = []
    for pos in range(0, n_layers, lc):
        layer = int(perm[pos])
        moves.append((layer // lc, layer // per, (layer % per) // lc, pos // per,
                      (pos % per) // lc))
    return moves, lc


def to_schedule_layout(leaves: list, axis: Axis, v: int, n_layers: int) -> list:
    """This rank's v chunks of the stacked ``leaves`` (each [L/P, ...],
    canonical: rank d holds layers d*L/P onward) in the interleaved
    schedule's layout: chunk c runs global stage c*P + d. A chunk held by
    another rank is sent over the axis. Each chunk's leaves are new leaf
    tensors with ``requires_grad`` (their gradients go back through
    ``from_schedule_layout``)."""
    moves, lc = _chunk_moves(n_layers, axis, v)
    d = axis.index
    sends, recvs, where = [], [], {}
    for i, leaf in enumerate(leaves):
        for g, src, k, dst, c in moves:
            tag = i * len(moves) + g
            if src == d:
                sends.append((leaf[k * lc:(k + 1) * lc].detach(), dst, tag))
            if dst == d:
                where[(c, i)] = len(recvs)
                recvs.append(((lc,) + tuple(leaf.shape[1:]), leaf.dtype, src, tag))
    got = collectives.send_recv(axis, sends, recvs, leaves[0].device)
    return [[got[where[(c, i)]].clone().requires_grad_(True) for i in range(len(leaves))]
            for c in range(v)]


def from_schedule_layout(chunk_grads: list, axis: Axis, n_layers: int) -> list:
    """The inverse of ``to_schedule_layout`` on the chunks' gradients: each
    leaf's gradient [L/P, ...] in the canonical layout."""
    v = len(chunk_grads)
    moves, lc = _chunk_moves(n_layers, axis, v)
    d = axis.index
    n_leaves = len(chunk_grads[0])
    sends, recvs, where = [], [], {}
    for i in range(n_leaves):
        g0 = chunk_grads[0][i]
        for g, src, k, dst, c in moves:
            tag = i * len(moves) + g
            if dst == d:
                sends.append((chunk_grads[c][i], src, tag))
            if src == d:
                where[(k, i)] = len(recvs)
                recvs.append((tuple(g0.shape), g0.dtype, dst, tag))
    got = collectives.send_recv(axis, sends, recvs, chunk_grads[0][0].device)
    return [torch.cat([got[where[(k, i)]] for k in range(v)]) for i in range(n_leaves)]
