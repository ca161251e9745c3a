"""The training driver: the port's ``Trainer`` over a staged token volume,
the window's tokens per second, the per-layer readings, and the
comparison with the plain reference's first three steps.

Set-up: weights from the seed; the mix's token volume written from the
seed into ``TMPDIR`` as an int32 ``.npy``, staged through
``CUDABackend`` and fed by ``data/feeds.volume_token_batches``; one
``Trainer`` over them. Its first three steps, each a ``Trainer.run`` call
of one step on that feed, are the steps the reference follows: each
step's loss, each leaf's first gradient as AdamW got it (its first
moment after step 1 over 1 - b1) and each leaf's change after step 3 are
read before step 4 runs. One more step warms up what remains; then the
window is one ``Trainer.run`` call of as many steps as the measured step
time fits into ``seconds``, synchronised at both ends."""

from __future__ import annotations

import gc
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import reference, traffic
from benchmark.harness.trace import Profiler, in_range, patched

CHECK_STEPS = 3
WARM_STEPS = 1  # after the checked steps, before the window
TRACE_STEPS = 3  # steps under the profiler in a --trace 1 run
RANGES = ("optimizer (AdamW.update)", "MoE FFN forward (moe.apply)")
CHUNK = 1 << 26  # elements a leaf's norm is taken over at once
MOMENT_MARGIN = 6 << 30  # device bytes the reference's moments leave free above its step's peak


def say(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def leaf_items(tree, prefix=()):
    """(path, tensor) of each leaf, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), tree


def norm(x: torch.Tensor) -> float:
    """The float32-accumulated 2-norm of ``x``, a slice at a time."""
    flat = x.detach().reshape(-1)
    total = 0.0
    for a in range(0, flat.numel(), CHUNK):
        part = flat[a:a + CHUNK].float()
        total += float(torch.dot(part, part))
    return math.sqrt(total)


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    fa, fb = a.detach().reshape(-1), b.detach().reshape(-1)
    total = 0.0
    for i in range(0, fa.numel(), CHUNK):
        part = fa[i:i + CHUNK].float() - fb[i:i + CHUNK].float()
        total += float(torch.dot(part, part))
    return math.sqrt(total)


def write_volume(path: str, n_tokens: int, vocab: int, seed: int) -> None:
    """An int32 ``.npy`` of ``n_tokens`` ids in [0, vocab) from ``seed``."""
    rng = np.random.default_rng(traffic._seed_words(seed) + [3])
    block = 1 << 22
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<i4", "fortran_order": False, "shape": (n_tokens,)})
        for a in range(0, n_tokens, block):
            rng.integers(0, vocab, min(block, n_tokens - a), dtype=np.int32).tofile(f)


def batch_rows(path: str, batch: int, seq: int, k: int) -> np.ndarray:
    """Batch ``k`` (0-based) of the sequential feed over the volume at
    ``path``, cut as the reference reads it: records of seq + 1 tokens
    back to back, batch k the records k*batch .. k*batch + batch - 1."""
    flat = np.load(path, mmap_mode="r")
    span = seq + 1
    records = flat[:(flat.size // span) * span].reshape(-1, span)
    idx = np.arange(k * batch, (k + 1) * batch) % records.shape[0]
    return np.array(records[idx])


def _faults(trainer, fault, vocab: int):
    """Break the timed path underneath (tests of the comparison only)."""
    import contextlib

    if fault is None:
        return contextlib.nullcontext()
    if fault == "unchanged":  # the step returns its state unchanged
        return patched(trainer.tx, "update", lambda f: lambda grads, st, params, norm=None:
                       torch.zeros((), device=next(leaf_items(params))[1].device))
    if fault == "half_batch":  # half the rows left out, the mean over the rest
        def wrap(step_fn):
            def half(state, batch):
                return step_fn(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
            return half
        return patched(trainer, "step_fn", wrap)
    if fault == "token":  # the tokens of the batch altered where the feed makes them
        def wrap(place):
            def altered(batch):
                out = place(batch)
                return {k: (v + 1) % vocab if k == "tokens" else v
                        for k, v in out.items()}
            return altered
        return patched(trainer, "place_batch", wrap)
    raise ValueError(f"unknown training fault {fault!r}")


def run(cell: dict, fam, d, mix: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, fault=None, control: bool = False) -> dict:
    """One run of a training cell of family ``fam`` (its module) at sizes
    ``d``; as ``serve.run``."""
    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.data.feeds import volume_token_batches
    from oim_tpu_torch.models import moe
    from oim_tpu_torch.spec import ArraySpec, FileParams
    from oim_tpu_torch.train import Trainer

    device = torch.device(device)
    cfg = fam.train_config(d, mix)
    B, T = mix["batch"], mix["seq"]
    tmp = tempfile.mkdtemp(prefix="benchmark-train-")
    path = os.path.join(tmp, "tokens.npy")
    n_tokens = int(mix["volume_mib"]) * (1 << 20) // 4
    write_volume(path, n_tokens, d.vocab, seed)
    backend = CUDABackend(device=str(device))
    vol = StagedVolume("benchmark-tokens", b"", ArraySpec())
    backend.stage(vol, "file", FileParams(path, "npy"))
    vol.wait()
    if vol.state != StageState.READY:
        raise RuntimeError(f"the token volume did not stage: {vol.state} {vol.error}")
    say(f"volume staged at {time.monotonic() - t_start:.2f} s")
    trainer = Trainer(cfg, device=str(device))
    trainer.init(params=fam.make_params(d, seed, device))
    feed = volume_token_batches(vol.array, cfg)
    b1 = trainer.tx.b1

    losses, grad_norms, change_norms, first = [], {}, {}, {}
    with _faults(trainer, fault, d.vocab):
        for k in range(1, CHECK_STEPS + 1):
            trainer.run(steps=k, data=feed)
            losses.append(trainer.history[-1]["loss"])
            if k == 1:
                mu = dict(leaf_items(trainer.state.opt_state.mu))
                grad_norms = {name: norm(m) / (1 - b1) for name, m in mu.items()}
                # the first gradient as AdamW got it, kept in host memory
                # (6.3 GB at the cell's size, so the window runs with the
                # program's memory alone) for the comparison with the
                # reference's, element by element
                first = {name: (m.detach().to("cpu", copy=True), 1 / (1 - b1))
                         for name, m in mu.items()}
                del mu
        init = fam.make_params(d, seed, device)
        change_norms = {name: diff_norm(p, p0) for (name, p), (_, p0)
                        in zip(leaf_items(trainer.state.params), leaf_items(init))}
        del init
        gc.collect()
        trainer.run(steps=CHECK_STEPS + WARM_STEPS, data=feed)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_s = trainer.history[-1]["step_s"]
        setup_s = time.monotonic() - t_start
        say(f"setup {setup_s:.2f} s; a step {step_s:.3f} s")

        # -- the window ----------------------------------------------------
        start = trainer.state.step
        n_steps = max(1, round(seconds / step_s))
        hist0 = len(trainer.history)
        t0 = time.monotonic()
        trainer.run(steps=start + n_steps, data=feed)
        if device.type == "cuda":
            torch.cuda.synchronize()
        window = time.monotonic() - t0
        traced = None
        if trace:
            prof = Profiler()
            with patched(trainer.tx, "update", in_range(RANGES[0])), \
                    patched(moe, "apply", in_range(RANGES[1])):
                prof.start()
                trainer.run(steps=trainer.state.step + TRACE_STEPS, data=feed)
                prof.stop()
            traced = prof.reduce(os.path.join(tmp, "trace.json"), RANGES)
            traced["steps"] = TRACE_STEPS
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window_hist = [h for h in trainer.history[hist0:] if "loss" in h]
    tokens = n_steps * B * T
    e2e = {"train_tokens_per_s": tokens / window, "setup_s": setup_s}
    context = {"kind": "train", "family": fam, "dims": d, "mix": mix, "window_s": window,
               "steps": n_steps, "tokens": tokens,
               "step_flops": fam.train_flops(d, B, T),
               "feed_wait_s": [h["feed_wait_s"] for h in window_hist],
               "trace": traced}
    say(f"window {window:.2f} s, {n_steps} steps")

    # -- the comparison with the reference -----------------------------------
    del trainer, feed
    backend.unstage(vol)
    del vol, backend
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    batches = [batch_rows(path, B, T, k) for k in range(CHECK_STEPS)]
    os.remove(path)
    os.rmdir(tmp)
    check = compare(fam, d, mix, seed, device, batches, losses, grad_norms, change_norms, first,
                    limits, control)
    say(f"reference {time.monotonic() - t_ref:.2f} s")
    return {"e2e": e2e, "context": context, "attempted": n_steps + CHECK_STEPS + WARM_STEPS,
            "failed": 0, "memory_peak_bytes": peak, "check": check}


def gaps(prog: dict, ref: dict, keep, scale: dict | None = None) -> float:
    """The worst leaf's |prog - ref| over the larger of that leaf's norm in
    ``scale`` (default ``ref``) and the median leaf's."""
    scale = ref if scale is None else scale
    median = float(np.median([scale[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(scale[k], median) for k in keep)


def compare(fam, d, mix, seed, device, batches, losses, grad_norms, change_norms, first,
            limits, control: bool) -> dict:
    """The numbers of the comparison with the reference's first three
    steps: the worst step's relative loss gap; by the worst leaf, the gap
    between the first gradient's norms, the norm of the first gradients'
    difference, and the gap between the change's norms after step 3
    (leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change). Each
    leaf's gap is taken over the larger of its reference norm and the
    median leaf's. The numbers ``limits`` names are compared; the others
    are reported. With ``control`` the fp8 reference is read the same way."""
    reference.no_tf32()
    judge = {"program": first}
    if control:
        low = reference_steps(fam, d, mix, seed, device, batches, quant="fp8",
                              keep_first=True)
        judge["control"] = {k: (g, 1.0) for k, g in low.pop("first").items()}
    ref = reference_steps(fam, d, mix, seed, device, batches, judge=judge)
    out = readings(ref, losses, grad_norms, change_norms, ref["first_diffs"]["program"])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in out.items() if k in limits}
    checks["ok"] = all(v["value"] <= v["limit"] for v in checks.values())
    checks.update({k: v for k, v in out.items() if k not in limits})
    checks["grad_diff_by_leaf"] = {k: round(v / max(ref["grad_norms"][k], _median(ref)), 5)
                                   for k, v in ref["first_diffs"]["program"].items()}
    if control:
        checks["control"] = readings(ref, low["losses"], low["grad_norms"],
                                     low["change_norms"], ref["first_diffs"]["control"])
        # the control held to the cell's own limits: it has to fail one
        checks["control_ok"] = all(v <= limits[k] for k, v in checks["control"].items()
                                   if k in limits)
    return checks


def _median(ref: dict) -> float:
    return float(np.median(list(ref["grad_norms"].values())))


def readings(ref: dict, losses, grad_norms, change_norms, first_diffs) -> dict:
    median_g = float(np.median(list(ref["grad_norms"].values())))
    moved = [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * median_g]
    every = list(ref["grad_norms"])
    zero = dict.fromkeys(every, 0.0)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
            "grad_gap": gaps(grad_norms, ref["grad_norms"], every),
            "grad_diff": gaps(first_diffs, zero, every, ref["grad_norms"]),
            "change_gap": gaps(change_norms, ref["change_norms"], moved)}


def reference_steps(fam, d, mix, seed, device, batches, quant=None, judge=None,
                    keep_first: bool = False) -> dict:
    """The plain reference's first steps (the family's ``loss``) from the
    same weights and rows: float32 params and AdamW state (optax's order:
    clip by global norm, moments, bias corrections, decoupled decay, lr at
    the count before the step), each layer recomputed in the backward pass
    to fit. ``judge``
    maps a name to host tensors by leaf, each with a factor, read as a
    first gradient: the norm of its difference from the reference's is
    returned by leaf under ``first_diffs``. ``keep_first`` returns the
    reference's own first gradient on the host (``first``)."""
    import torch.utils.checkpoint as ckpt

    opt = mix["optimizer"]
    lr_at = lambda count: _schedule(opt, count)  # noqa: E731
    init = fam.make_params(d, seed, device)
    names = [n for n, _ in leaf_items(init)]
    params = [p.detach().float().clone().requires_grad_(True) for _, p in leaf_items(init)]
    del init
    tree = _unflatten(names, params)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    mu, nu = [], []
    losses, grad_norms, first = [], {}, {}
    diffs = {key: {} for key in (judge or {})}
    b1, b2, eps, wd, clip = 0.9, 0.95, 1e-8, opt["weight_decay"], 1.0
    for k, rows in enumerate(batches):
        tokens = torch.from_numpy(rows.astype(np.int64)).to(device)
        loss = fam.loss(tree, d, tokens, quant, ckpt)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            if k == 0:
                mu, nu = _moments(params, device)
            gnorm = math.sqrt(sum(norm(g) ** 2 for g in grads))
            scale = clip / gnorm if gnorm >= clip else 1.0
            count = k + 1
            lr = lr_at(k)
            for i, (p, g) in enumerate(zip(params, grads)):
                if k == 0:
                    grad_norms[names[i]] = norm(g) * scale
                    for key, leaves in (judge or {}).items():
                        host, factor = leaves[names[i]]
                        diffs[key][names[i]] = _diff_host(g, scale, host, factor)
                    if keep_first:
                        first[names[i]] = (g * scale).cpu()
                pf, gf = p.view(-1), g.view(-1)
                mf, vf = mu[i].view(-1), nu[i].view(-1)
                for a in range(0, pf.numel(), CHUNK):
                    gs = gf[a:a + CHUNK] * scale
                    if k == 0:
                        m, v = (1 - b1) * gs, (1 - b2) * gs * gs
                    else:
                        m = mf[a:a + CHUNK].to(device).mul_(b1).add_(gs, alpha=1 - b1)
                        v = vf[a:a + CHUNK].to(device).mul_(b2).addcmul_(gs, gs, value=1 - b2)
                    u = (m / (1 - b1 ** count)) / (torch.sqrt(v / (1 - b2 ** count)) + eps)
                    ps = pf[a:a + CHUNK]
                    ps.sub_(lr * (u + wd * ps))
                    mf[a:a + CHUNK].copy_(m)
                    vf[a:a + CHUNK].copy_(v)
        del grads
        if device.type == "cuda":  # each step's activations from a clean cache
            torch.cuda.empty_cache()
    del mu, nu
    init = fam.make_params(d, seed, device)
    change_norms = {n: diff_norm(p, p0) for n, p, (_, p0) in zip(names, params, leaf_items(init))}
    del init, params, tree
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms,
            "first_diffs": diffs, "first": first}


def _moments(params, device) -> tuple[list, list]:
    """AdamW's float32 moments of each leaf (25 GB at the cell's size),
    made once the first step's backward pass has set the step's peak: on
    the device while that peak leaves room for them, the rest in pinned
    host memory, which the update reads and writes a slice at a time."""
    room = 0
    if device.type == "cuda":  # the peak the allocator reserved, its unused blocks with it
        room = (torch.cuda.get_device_properties(device).total_memory
                - torch.cuda.max_memory_reserved(device) - MOMENT_MARGIN)
        torch.cuda.empty_cache()
    mu, nu, on_host = [], [], 0
    for p in params:
        need = 2 * p.numel() * 4
        if device.type != "cuda" or need <= room:
            room -= need
            home = {"device": device}
        else:
            on_host += need
            home = {"pin_memory": True}
        mu.append(torch.empty(p.shape, dtype=torch.float32, **home))
        nu.append(torch.empty(p.shape, dtype=torch.float32, **home))
    if device.type == "cuda":
        total = sum(2 * p.numel() * 4 for p in params)
        say(f"reference moments: {(total - on_host) / 1e9:.1f} GB on the device, "
            f"{on_host / 1e9:.1f} GB in pinned host memory")
    return mu, nu


def _diff_host(g, scale: float, host, factor: float) -> float:
    """||g * scale - host * factor||, ``host`` (on the host or the device)
    brought over a slice at a time."""
    gf, hf = g.reshape(-1), host.reshape(-1)
    total = 0.0
    for a in range(0, gf.numel(), CHUNK):
        part = gf[a:a + CHUNK] * scale - hf[a:a + CHUNK].to(g.device).float() * factor
        total += float(torch.dot(part, part))
    return math.sqrt(total)


def _schedule(opt: dict, count: int) -> float:
    """optax's warmup_cosine_decay_schedule from 0 to lr over
    warmup_steps, then cosine to lr / 10 at total_steps."""
    peak, warm, total = opt["lr"], opt["warmup_steps"], max(opt["total_steps"],
                                                             opt["warmup_steps"] + 1)
    if count < warm:
        return peak * count / warm
    c = min(count - warm, total - warm)
    return peak * (0.9 * 0.5 * (1 + math.cos(math.pi * c / (total - warm))) + 0.1)


def _unflatten(names, leaves) -> dict:
    tree: dict = {}
    for name, leaf in zip(names, leaves):
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree
