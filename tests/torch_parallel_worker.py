"""One rank of a multi-rank run of the port on the CPU, for
tests/test_torch_parallel.py, tests/test_torch_parallel_train.py,
tests/test_torch_tp.py, tests/test_torch_ep.py,
tests/test_torch_resnet_parallel.py, tests/test_torch_checkpoint_mesh.py,
tests/test_torch_pipe.py and tests/test_torch_tp_headsplit.py.

    python tests/torch_parallel_worker.py JOB.json RANK

JOB.json names the world size, a FileStore path for the rendezvous, an
.npz of inputs, the output directory and the scenarios. The rank joins a
gloo group, runs every scenario in order (each one collective over the
world, so every rank runs the same list), and writes what it computed to
``<out>/rank<RANK>.npz`` as ``<scenario>/<item>`` arrays. It imports the
port, numpy and torch only: JAX stays in the test process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch.nn.functional as F  # noqa: E402

from oim_tpu_torch.models import llama, moe, resnet  # noqa: E402
from oim_tpu_torch.ops.losses import vocab_parallel_cross_entropy  # noqa: E402
from oim_tpu_torch.parallel import collectives as C  # noqa: E402
from oim_tpu_torch.parallel import pipeline, pipeline_1f1b, ring  # noqa: E402
from oim_tpu_torch.parallel.mesh import Mesh, build_mesh  # noqa: E402
from oim_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from oim_tpu_torch.train import trainer as T  # noqa: E402
from oim_tpu_torch.train.state import tree_leaves  # noqa: E402


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def collectives(sc, inputs, rank, world, out):
    """Each collective on this rank's block of a global input, and its
    backward against this rank's block of a cotangent."""
    axes = [tuple(a) for a in sc["axes"]]
    mesh = build_mesh(axes, device="cpu")
    names = [a for a, _ in axes]
    ax = [mesh.axis(n) for n in names]
    x_all, ops = inputs[f"{sc['name']}/x"], sc["ops"]
    rows = x_all.shape[0] // world
    x0 = torch.tensor(x_all[rank * rows:(rank + 1) * rows])
    fns = {
        "psum": lambda x: C.psum(x, ax),
        "pmean": lambda x: C.pmean(x, ax),
        "all_gather": lambda x: C.all_gather(x, ax[0], gather_dim=1),
        "all_gather_untiled": lambda x: C.all_gather(x, ax[0], tiled=False, gather_dim=1),
        "gather_from": lambda x: C.gather_from(x, ax[0], gather_dim=1),
        "reduce_scatter": lambda x: C.reduce_scatter(x, ax[0], scatter_dim=1),
        "all_to_all": lambda x: C.all_to_all(x, ax[0], split_dim=1, concat_dim=0),
        "ppermute": lambda x: C.ppermute_ring(x, ax[0]),
        "ppermute_back2": lambda x: C.ppermute_ring(x, ax[0], shift=-2),
    }
    for op in ops:
        x = x0.clone().requires_grad_(True)
        y = fns[op](x)
        c_all = inputs[f"{sc['name']}/c_{op}"]
        crow = c_all.shape[0] // world
        y.backward(torch.tensor(c_all[rank * crow:(rank + 1) * crow]))
        out[f"{sc['name']}/{op}/y"] = y.detach().numpy()
        out[f"{sc['name']}/{op}/dx"] = x.grad.numpy()
    out[f"{sc['name']}/index"] = np.asarray([C.axis_index(a) for a in ax])
    out[f"{sc['name']}/size"] = np.asarray([C.axis_size(a) for a in ax])


def attention(sc, inputs, rank, world, out, mesh):
    """One sequence-parallel attention case on this rank's shards, with the
    count of block attentions (K1's calls on a card) it ran."""
    name, kind, causal = sc["name"], sc["kind"], sc["causal"]
    q, k, v, g = (inputs[f"{name}/{x}"] for x in ("q", "k", "v", "g"))
    layout = "zigzag" if kind == "zigzag" and causal else "ring"
    pos = ring.shard_positions(q.shape[1], world, rank, layout)
    q_r, k_r, v_r = (torch.tensor(x[:, pos]).requires_grad_(True) for x in (q, k, v))
    calls = {"n": 0}
    wrapped = {}
    for fn_name in ("attention_with_lse", "attention"):
        orig = getattr(ring, fn_name)

        def counted(*a, _orig=orig, **kw):
            calls["n"] += 1
            return _orig(*a, **kw)

        wrapped[fn_name] = orig
        setattr(ring, fn_name, counted)
    try:
        o = ring.make_sequence_parallel_attention(mesh, kind=kind, causal=causal)(q_r, k_r, v_r)
    finally:
        for fn_name, orig in wrapped.items():
            setattr(ring, fn_name, orig)
    o.backward(torch.tensor(g[:, pos]))
    out[f"{name}/pos"] = pos
    out[f"{name}/out"] = o.detach().numpy()
    for x, t in (("dq", q_r), ("dk", k_r), ("dv", v_r)):
        out[f"{name}/{x}"] = t.grad.numpy()
    out[f"{name}/calls"] = np.asarray(calls["n"])


def _model_axis(world):
    return build_mesh([("model", world)], device="cpu").axis("model")


def tp_ops(sc, inputs, rank, world, out):
    """A Megatron MLP on this rank's slices: ``copy_to`` into a
    column-split product, ``reduce_from`` out of a row-split one; the
    output and the gradients of x and of this rank's weight slices."""
    name, ax = sc["name"], _model_axis(world)
    C.reset_counts()
    x = torch.tensor(inputs[f"{name}/x"]).requires_grad_(True)
    w_all, v_all = inputs[f"{name}/w"], inputs[f"{name}/v"]
    cols = w_all.shape[1] // world
    w = torch.tensor(w_all[:, rank * cols:(rank + 1) * cols]).requires_grad_(True)
    v = torch.tensor(v_all[rank * cols:(rank + 1) * cols]).requires_grad_(True)
    y = C.reduce_from(F.silu(C.copy_to(x, ax) @ w) @ v, ax)
    y.backward(torch.tensor(inputs[f"{name}/g"]))
    out[f"{name}/y"] = y.detach().numpy()
    for key, t in (("dx", x), ("dw", w), ("dv", v)):
        out[f"{name}/{key}"] = t.grad.numpy()
    out[f"{name}/calls"] = np.asarray(C.CALLS["psum"])
    # The plain psum (whose backward sums again) in reduce_from's place.
    x2 = x.detach().clone().requires_grad_(True)
    C.psum(F.silu(C.copy_to(x2, ax) @ w.detach()) @ v.detach(), ax).backward(
        torch.tensor(inputs[f"{name}/g"]))
    out[f"{name}/dx_plain_psum"] = x2.grad.numpy()


def vocab_ce(sc, inputs, rank, world, out):
    """``vocab_parallel_cross_entropy`` on this rank's head slice for each
    case (vocab_chunk, z_loss, reduction): the loss, the z-loss term, dy
    and this slice's gradient."""
    name, ax = sc["name"], _model_axis(world)
    w_all = inputs[f"{name}/w"]
    cols = w_all.shape[1] // world
    labels = torch.tensor(inputs[f"{name}/labels"]).long()
    for i, (chunk, z_loss, reduction) in enumerate(sc["cases"]):
        y = torch.tensor(inputs[f"{name}/y"]).requires_grad_(True)
        w = torch.tensor(w_all[:, rank * cols:(rank + 1) * cols]).requires_grad_(True)
        before = dict(C.CALLS)
        loss, z_term = vocab_parallel_cross_entropy(
            y, w, labels, ax, ignore_index=-1, reduction=reduction, z_loss=z_loss,
            vocab_chunk=chunk, return_z_term=True)
        fwd_calls = {op: C.CALLS[op] - before[op] for op in C.CALLS}
        loss.backward()
        out[f"{name}/{i}/loss"] = loss.detach().numpy()
        out[f"{name}/{i}/z_term"] = z_term.detach().numpy()
        out[f"{name}/{i}/dy"] = y.grad.numpy()
        out[f"{name}/{i}/dw"] = w.grad.numpy()
        out[f"{name}/{i}/fwd_calls"] = np.asarray([fwd_calls["pmax"], fwd_calls["psum"]])


def _config(raw: dict) -> T.TrainConfig:
    """A TrainConfig from JSON: a model_overrides dtype arrives by name."""
    raw = dict(raw)
    over = dict(raw.get("model_overrides", {}))
    if isinstance(over.get("dtype"), str):
        over["dtype"] = getattr(torch, over["dtype"])
    return T.TrainConfig(**{**raw, "model_overrides": over})


def _lib(cfg: T.TrainConfig):
    return resnet if cfg.model == "resnet50" else llama


def _tree(inputs: dict, prefix: str) -> dict:
    return unflatten({k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)})


def _init(tr, inputs: dict, prefix: str = "params/") -> None:
    """The JAX Trainer's initial params (and BN state) from the inputs
    (the params under ``prefix``)."""
    lib = _lib(tr.cfg)
    extra = _tree(inputs, "extra/")
    tr.init(lib.from_numpy(_tree(inputs, prefix), device="cpu"),
            lib.from_numpy(extra, device="cpu") if extra else None)


def _batches(name: str, inputs: dict, cfg: T.TrainConfig):
    """The scenario's global batches from the inputs, else the synthetic
    stream."""
    if f"{name}/tokens" in inputs:
        return iter({"tokens": t} for t in inputs[f"{name}/tokens"])
    if f"{name}/images" in inputs:
        return iter({"images": i, "labels": lb} for i, lb in
                    zip(inputs[f"{name}/images"], inputs[f"{name}/labels"]))
    return T.synthetic_batches(cfg)


def _eval_batch(name: str, inputs: dict) -> dict:
    if f"{name}/eval_tokens" in inputs:
        return {"tokens": inputs[f"{name}/eval_tokens"]}
    return {"images": inputs[f"{name}/eval_images"], "labels": inputs[f"{name}/eval_labels"]}


@contextlib.contextmanager
def planted(fault: str | None):
    """A fault the tests must catch, patched into this rank's port:
    "local_routing" routes each rank's own tokens (local capacity and
    slots); "rs_backward" gathers the router's columns with the plain
    all_gather, whose backward reduce-scatters a cotangent already whole on
    every rank; "aux_everywhere" counts the load-balance loss in full on
    every rank of the token-splitting axes; "rank_bn" takes batch norm's
    statistics over this rank's rows only; "head_unsummed" lets the
    pipeline head's replicated input in without ``copy_to`` (the psum of
    its cotangent over the vocab split forgotten); "canonical_order" runs
    interleaved 1F1B on the canonical layer order; "gather_from" gathers q
    over a head-splitting model axis with ``gather_from``, whose backward
    keeps this rank's share of a straddling head's cotangent alone."""
    if fault is None:
        yield
        return
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    apply, batchnorm = moe.apply, resnet._batchnorm
    if fault == "local_routing":
        def local(params, x, cfg, with_stats=False, ctx=None):
            if ctx is not None:
                ctx = dataclasses.replace(ctx, batch=(), seq=None)
            return apply(params, x, cfg, with_stats, ctx)
        patch(moe, "apply", local)
    elif fault == "rs_backward":
        patch(C, "gather_from", lambda x, axis, gather_dim=0: C.all_gather(
            x, axis, gather_dim=gather_dim))
    elif fault == "aux_everywhere":
        def everywhere(params, x, cfg, with_stats=False, ctx=None):
            out, stats = apply(params, x, cfg, with_stats, ctx)
            n = 1
            if ctx is not None:
                for axis in (*ctx.batch, ctx.seq):
                    n *= axis.size if axis is not None else 1
            return out, stats * torch.tensor([float(n), 1.0])
        patch(moe, "apply", everywhere)
    elif fault == "gather_from":
        patch(llama, "_gather_heads", lambda q, tp: C.gather_from(q, tp, gather_dim=2))
    elif fault == "head_unsummed":
        patch(C, "copy_to", lambda x, axis: x)
    elif fault == "canonical_order":
        def canonical(n_layers, p, v):
            order = np.arange(n_layers, dtype=np.int32)
            return order, order
        patch(pipeline_1f1b, "interleave_layer_permutation", canonical)
    elif fault == "rank_bn":
        patch(resnet, "_batchnorm", lambda x, p, s, training, momentum, eps, batch_axes=():
              batchnorm(x, p, s, training, momentum, eps))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def train(sc, inputs, rank, world, out):
    """The port's Trainer on the scenario's axes, from the given full
    params, one step at a time: per-step loss, grad_norm (and MoE drop
    share), this rank's shards after each step, the gathered final params
    (and a model's state), and an eval pass; ``fault`` planted first."""
    name = sc["name"]
    cfg = _config(sc["cfg"])
    axes = [tuple(a) for a in sc["axes"]]
    with planted(sc.get("fault")):
        tr = T.Trainer(cfg, device="cpu", axes=axes)
        _init(tr, inputs, sc.get("params", "params/"))
        data = _batches(name, inputs, cfg)
        for step in range(sc["steps"]):
            tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
            if cfg.rules == "pipe" and cfg.pipeline_schedule == "1f1b":
                out[f"{name}/stash_peak{step}"] = np.asarray(
                    [pipeline_1f1b.STASH_PEAK["x"], pipeline_1f1b.STASH_PEAK["dh"]])
            if cfg.rules == "pipe":
                out[f"{name}/embed_held{step}"] = np.asarray(
                    [llama.PIPE_HELD[k] for k in ("x", "d_x", "d_rows")])
            out[f"{name}/loss{step}"] = np.asarray(float(stats["loss"]))
            out[f"{name}/grad_norm{step}"] = np.asarray(float(stats["grad_norm"]))
            if "moe_drop_frac" in stats:
                out[f"{name}/drop{step}"] = np.asarray(float(stats["moe_drop_frac"]))
            for leaf, t in _leaf_items(tr.state.params):
                out[f"{name}/shard{step}/{leaf}"] = t.detach().numpy().copy()
        for leaf, t in _leaf_items(tr.full_params()):
            out[f"{name}/final/{leaf}"] = t.numpy()
        for leaf, t in _leaf_items(tr.state.extra):
            out[f"{name}/extra/{leaf}"] = t.detach().numpy()
        out[f"{name}/eval_loss"] = np.asarray(tr.evaluate(iter([_eval_batch(name, inputs)]), 1))
    # Which piece of each leaf this rank holds: ranks with the same pieces
    # hold replicas, which must stay equal to the bit.
    for (leaf, _), s in zip(_leaf_items(tr.state.params), tree_leaves(tr.shardings)):
        out[f"{name}/piece/{leaf}"] = np.asarray(
            [s.parts(tr.mesh, d)[1] for d in range(len(s.dims))], dtype=np.int64)


def pipe_toy(sc, inputs, rank, world, out):
    """GPipe, or 1F1B with ``v`` chunks a rank, over a pipe axis of the
    world on a toy stage (tanh(h @ w + b) per layer, this rank's L/P layers
    held canonically) and a replicated MSE head, each microbatch weighted
    1/M: the loss, this rank's gradient pieces, the head's gradient, the
    inputs' cotangents and (1F1B) the stash peaks."""
    name, schedule, v = sc["name"], sc["schedule"], sc.get("v", 1)
    axis = build_mesh([("pipe", world)], device="cpu").axis("pipe")
    w, b = inputs[f"{name}/w"], inputs[f"{name}/b"]
    n_layers, m = w.shape[0], inputs[f"{name}/x"].shape[0]
    per = n_layers // world
    mine = slice(rank * per, (rank + 1) * per)
    leaves = [torch.tensor(w[mine]).requires_grad_(True),
              torch.tensor(b[mine]).requires_grad_(True)]
    head = [torch.tensor(inputs[f"{name}/wo"]).requires_grad_(True)]
    xs = [torch.tensor(x) for x in inputs[f"{name}/x"]]
    tgt = [torch.tensor(t) for t in inputs[f"{name}/tgt"]]

    def head_fn(h, j):
        return torch.mean((h @ head[0] - tgt[j]) ** 2), None

    chunks = [leaves]
    if schedule == "1f1b" and v > 1:
        chunks = pipeline_1f1b.to_schedule_layout(leaves, axis, v, n_layers)

    def stage(h, c):
        cw, cb = chunks[c]
        for i in range(cw.shape[0]):
            h = torch.tanh(h @ cw[i] + cb[i])
        return h, None

    weights = [1.0 / m] * m
    feed = pipeline.Feed(xs)
    if schedule == "gpipe":
        res = pipeline.pipeline_value_and_grad(stage, head_fn, leaves, head, feed, weights, axis)
        d_stage = res.d_stage[0]
    else:
        res = pipeline_1f1b.pipeline_1f1b_value_and_grad(stage, head_fn, chunks, head, feed,
                                                         weights, axis)
        d_stage = res.d_stage[0] if v == 1 else pipeline_1f1b.from_schedule_layout(
            res.d_stage, axis, n_layers)
        out[f"{name}/stash_peak"] = np.asarray(
            [pipeline_1f1b.STASH_PEAK["x"], pipeline_1f1b.STASH_PEAK["dh"]])
    out[f"{name}/loss"] = res.loss.numpy()
    out[f"{name}/dw"], out[f"{name}/db"] = (g.numpy() for g in d_stage)
    out[f"{name}/dwo"] = res.d_head[0].numpy()
    # The inputs' cotangents, kept by the axis's first rank, on every rank.
    stacked = torch.stack(feed.d_x) if axis.index == 0 else None
    out[f"{name}/dx"] = pipeline.broadcast_from(stacked, axis, 0, torch.stack(xs)).numpy()


def batchnorm(sc, inputs, rank, world, out):
    """``resnet._batchnorm`` in training mode on this rank's rows of a
    global NCHW batch over a data axis of the world (and, as a control, on
    the rows alone): the output, the gradients of x, scale and bias
    against this rank's rows of a cotangent, and the new running
    statistics."""
    name = sc["name"]
    axis = build_mesh([("data", world)], device="cpu").axis("data")
    rows = inputs[f"{name}/x"].shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    for tag, axes in (("global", [axis]), ("own", [])):
        x = torch.tensor(inputs[f"{name}/x"][mine]).requires_grad_(True)
        p = {k: torch.tensor(inputs[f"{name}/{k}"]).requires_grad_(True)
             for k in ("scale", "bias")}
        s = {k: torch.tensor(inputs[f"{name}/{k}"]) for k in ("mean", "var")}
        y, new_s = resnet._batchnorm(x, p, s, True, 0.9, 1e-5, batch_axes=axes)
        y.backward(torch.tensor(inputs[f"{name}/g"][mine]))
        out[f"{name}/{tag}/y"] = y.detach().numpy()
        out[f"{name}/{tag}/dx"] = x.grad.numpy()
        for k in ("scale", "bias"):
            out[f"{name}/{tag}/d{k}"] = p[k].grad.numpy()
        for k in ("mean", "var"):
            out[f"{name}/{tag}/{k}"] = new_s[k].numpy()


def _record(out, name, tr) -> None:
    steps = [r for r in tr.history if "loss" in r]
    out[f"{name}/steps"] = np.asarray([r["step"] for r in steps])
    out[f"{name}/losses"] = np.asarray([r["loss"] for r in steps])
    out[f"{name}/norms"] = np.asarray([r["grad_norm"] for r in steps])
    if steps and "moe_drop_frac" in steps[0]:
        out[f"{name}/drops"] = np.asarray([r["moe_drop_frac"] for r in steps])


def checkpointed(sc, inputs, rank, world, out):
    """A Trainer run with a checkpoint directory. "save" starts from the
    given params and, with ``copies``, has rank 0 copy the saved step into
    those directories afterwards; "resume" restores the latest step (on
    rank 0 alone, one process with no group, with ``one_process``);
    ``kill_rank`` leaves the run after that rank's pieces of ``kill_step``
    are durable and before its marker. Records the logged steps and the
    final full params."""
    name = sc["name"]
    cfg = _config(sc["cfg"])
    if sc.get("one_process"):
        if rank != 0:
            return
        tr = T.Trainer(cfg, device="cpu",
                       mesh=Mesh([(a, 1) for a, _ in sc["axes"]], [0], "cpu"))
    else:
        tr = T.Trainer(cfg, device="cpu", axes=[tuple(a) for a in sc["axes"]])
    if rank == sc.get("kill_rank"):
        mark = ckpt.Checkpointer._mark_done

        def killed(self, tmp, member):
            if os.path.basename(tmp).startswith(f"{ckpt._TMP}{sc['kill_step']}-"):
                os._exit(9)
            mark(self, tmp, member)
        ckpt.Checkpointer._mark_done = killed
    if sc["phase"] == "save":
        _init(tr, inputs, sc.get("params", "params/"))
    t0 = time.monotonic()
    tr.run(steps=sc["steps"])
    out[f"{name}/seconds"] = np.asarray(time.monotonic() - t0)
    _record(out, name, tr)
    full = tr.full_params() if not sc.get("one_process") else tr.state.params
    for leaf, t in _leaf_items(full):
        out[f"{name}/final/{leaf}"] = t.detach().numpy()
    if sc.get("copies"):
        dist.barrier()  # every rank's pieces are in and rank 0 committed
        if rank == 0:
            step = tr.checkpointer.latest_step()
            for dst in sc["copies"]:
                shutil.copytree(os.path.join(cfg.checkpoint_dir, str(step)),
                                os.path.join(dst, str(step)))
        dist.barrier()


def unflatten(flat: dict) -> dict:
    """{'a.b': x} -> {'a': {'b': x}}."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


class Job:
    """A world of rank processes running this module on one job: started
    when made, collected by ``results``."""

    def __init__(self, tmp: Path, world: int, inputs: dict, scenarios: list,
                 timeout: float):
        self.world, self.timeout, self.dir = world, timeout, Path(tmp) / f"world{world}"
        self.dir.mkdir(parents=True)
        np.savez(self.dir / "inputs.npz", **inputs)
        job = {"world": world, "store": str(self.dir / "store"),
               "inputs": str(self.dir / "inputs.npz"), "out": str(self.dir),
               "scenarios": scenarios}
        (self.dir / "job.json").write_text(json.dumps(job))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.t0 = time.monotonic()
        self.procs = []
        for r in range(world):
            with open(self.dir / f"rank{r}.err", "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(self.dir / "job.json"), str(r)],
                    env=env, stdout=subprocess.DEVNULL, stderr=err))

    def results(self) -> list[dict]:
        """Each rank's arrays. A rank that fails, or a job that outlives its
        timeout, kills every rank and raises with their stderr."""
        while True:
            codes = [p.poll() for p in self.procs]
            late = time.monotonic() - self.t0 > self.timeout
            if all(c == 0 for c in codes):
                break
            if late or any(c not in (None, 0) for c in codes):
                for p in self.procs:
                    p.kill()
                    p.wait()
                errs = "\n".join(f"--- rank {r} (exit {c}):\n"
                                 + (self.dir / f"rank{r}.err").read_text()[-3000:]
                                 for r, c in enumerate(codes))
                why = f"timed out after {self.timeout} s" if late else "a rank failed"
                raise RuntimeError(f"world {self.world}: {why}\n{errs}")
            time.sleep(0.05)
        self.seconds = time.monotonic() - self.t0
        return [dict(np.load(self.dir / f"rank{r}.npz")) for r in range(self.world)]


def main() -> int:
    job = json.loads(Path(sys.argv[1]).read_text())
    rank, world = int(sys.argv[2]), job["world"]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], world),
                            rank=rank, world_size=world)
    inputs = dict(np.load(job["inputs"]))
    out: dict = {}
    attn_mesh = None
    for sc in job["scenarios"]:
        if sc["type"] == "collectives":
            collectives(sc, inputs, rank, world, out)
        elif sc["type"] == "attention":
            if attn_mesh is None:
                attn_mesh = build_mesh([("data", 1), ("seq", world)], device="cpu")
            attention(sc, inputs, rank, world, out, attn_mesh)
        elif sc["type"] == "tp_ops":
            tp_ops(sc, inputs, rank, world, out)
        elif sc["type"] == "vocab_ce":
            vocab_ce(sc, inputs, rank, world, out)
        elif sc["type"] == "batchnorm":
            batchnorm(sc, inputs, rank, world, out)
        elif sc["type"] == "checkpoint":
            checkpointed(sc, inputs, rank, world, out)
        elif sc["type"] == "pipe_toy":
            pipe_toy(sc, inputs, rank, world, out)
        else:
            train(sc, inputs, rank, world, out)
    out["staged_calls"] = np.asarray(sum(C.STAGED_CALLS.values()))
    np.savez(Path(job["out"]) / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
