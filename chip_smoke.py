"""Chip smoke test of the PyTorch/CUDA port (``oim_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns of
                                       # one llama training step, one decode
                                       # step, one ResNet step and one MoE
                                       # step into chiprun_out/

Phases, in order; any failure exits nonzero:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, TF32 off for every float32 product.
2. build: the three flash-attention kernels compiled from
   ``oim_tpu_torch/kernels/csrc`` (one nvcc per source, all at once), with
   ptxas's register and spill lines printed; then the C++ read engine
   compiled by g++ from ``native/staging.cc`` into
   ``oim_tpu_torch/data/build/`` and loaded (g++'s version and whether
   libjpeg was found printed). A failed build fails the run.
3. kernels: each kernel (K1 forward, K2 dK/dV, K3 dQ) held against its
   plain PyTorch version on the same inputs, at the attention shape of
   each training path the script drives (llama3-8b's, GQA group 4, for
   phases 5, 8 and 9; the MoE flagship's, group 2, for phase 11; both bf16
   causal at head_dim 128 and required to take the wgmma route) and
   on small odd shapes (non-causal, GQA groups 1 and 4, tq < tk, tq > tk
   with fully masked rows, lengths not a multiple of the tile, a delta that
   carries an lse cotangent, a bf16 head_dim that the kernels serve by the
   fma route); each K1 launch must take the route ``kernels.fwd_route``
   names, each K2/K3 launch the one ``kernels.bwd_route`` names. Its time
   (at llama3-8b's shape) beside its plain version's, its bound, and scaled_dot_product_attention
   with an explicit bottom-right mask as a yardstick the port never calls;
   each kernel also timed on its fma route (the first port's kernels) on
   the same inputs, and each route's registers, spills, shared memory and
   blocks per SM printed.
4. agreement: llama.tiny's loss and gradients on the card (kernels) held
   against the same model on the CPU (plain versions).
5. main path: the CLI's Trainer on llama3-8b at full width, cut to
   LAYERS layers, B=BATCH, T=SEQ, for STEPS steps. Every loss finite,
   the first near ln(vocab), each kernel's launch count equal to
   n_layers x steps, and every K1, K2 and K3 launch on the wgmma route.
6. serving agreement (llama.tiny, f32, TF32 off): ``prefill_into_pages``,
   ``decode_step`` and ``verify_step`` logits on the card held against the
   CPU; the engine's greedy streams on the card equal to solo
   ``generate()`` on the card; a self-draft speculating engine's greedy
   streams equal to the plain engine's; a host-tier demote -> promote
   round trip of a bf16 page exact to the bit.
7. serving main path: ``ServeEngine`` on llama3-8b at full width and full
   depth (32 layers, bf16, weights from ``llama.init`` on the card), 12
   requests from a seeded numpy generator (prompts of 17..1500 tokens,
   four sharing a 512-token prefix, half greedy and half sampled, one
   cancelled after 8 tokens). It fails unless every request ends as it
   must, the prefix store serves 3 hits (3 x 512 tokens), a request
   promoted back from the host tier repeats its first stream, and the
   pool is empty after drain and eviction, and an 8-row paged batch's
   first-decode logits lie within SERVE_LOGIT_REL x max|logit| of solo
   ``cached_forward``; then a self-draft speculating engine must accept
   tokens (> 1 token per target step). It prints the first token of one
   request on an idle engine (miss and host-tier hit), the burst's
   first-token and inter-token percentiles as smoke readings (12
   requests are not a load), the 8-row decode step's time beside its
   bound, solo prefill times by bucket, peak memory, greedy agreement
   with solo ``generate()`` (reported, not required), and the ``serve``
   JSON line.
   ``--profile`` adds a torch.profiler breakdown of one 8-row decode step
   (``chiprun_out/chip_smoke_serve_profile.json``).
8. OIM-fed training: a 4 GiB int32 token volume (FED_TOKENS tokens from a
   seeded generator) written as .npy to a temporary directory and staged
   through ``CUDABackend`` (64 MiB chunks, an 8 GiB stage cache). First
   two chunks of it are staged into a block freed while queued work on
   the current stream still writes it, and must land intact. It fails
   unless the stage ends READY with the device's allocation growing by at
   most the volume + 2 chunks, the staged tensor equals the file byte for
   byte, a restage after unstage is served from the cache (no plane call,
   the same storage), a stage unstaged after FED_CANCEL_AT landed bytes
   ends FAILED "unmapped during staging", and after eviction
   ``memory_allocated`` is back where the phase began, and unless the
   cold stage read through the native engine (``read_path()``); then the
   Trainer of phase 5 runs STEPS steps on ``volume_token_batches`` of the
   staged volume, with phase 5's checks (finite losses, the first near
   ln(vocab), K1-K3 at LAYERS x STEPS launches each, all on ``wgmma``).
   It prints the stage's time, GB/s and breakdown (disk_s, h2d_s,
   dispatch_s), yardsticks timed in the same run (a pinned 64 MiB copy to
   the card; the file read alone into a torch-pinned 64 MiB buffer by
   each read engine, native with 8 threads, io_uring and preadv threads,
   in two rounds of turned order, each read byte-checked against the
   file, an engine the host refuses
   recorded as "unavailable: <errno>"; all from a warm page cache) and
   the stage's bound from the H2D and the fastest engine, the cache-hit
   time, and step_s and MFU beside phase 5's; then the ``oim_fed`` JSON
   line (``read_gbps_by_engine``).
9. OIM-fed ResNet-50, bench.py's cell at full width (bench.py:333-342,
   :426-500): 1024 seeded uint8 images [1024,224,224,3] written raw to a
   temporary directory, staged through ``CUDABackend`` and checked byte
   for byte; the Trainer on resnet50 (bf16, batch 128 sliced in place from
   the staged tensor at bench.py's offsets, 1000 classes) for 8 steps with
   a checkpoint every 4. It fails unless every loss is finite, the first
   within 1.0 of ln 1000, every BN running statistic finite and moved, and
   no K1-K3 kernel launched; then two eval batches in inference mode
   (finite loss, accuracy in [0, 1], the BN state byte-identical after); a
   fresh Trainer resumed from the step-4 checkpoint (the step-8 one
   removed, a partial temporary one left) must restore every tensor byte
   for byte and repeat steps 5-8's losses within RESNET_REL_TOL; one remat
   step from a copy of the state must repeat the plain step's loss,
   grad_norm and updated params within RESNET_REL_TOL and its gradients
   within RESNET_GRAD_TOL (worst leaf); phase 5's llama with ``--remat`` must launch K1 2 x
   layers x steps times and K2/K3 layers x steps, all on ``wgmma``, with
   phase 5's losses within RESNET_REL_TOL. It prints step_s, images/s,
   MFU, peak memory, the stage, checkpoint save and restore times, and the
   ``resnet`` JSON line. ``--profile`` adds one profiled ResNet step by
   category (``chiprun_out/chip_smoke_resnet_profile.json``).
10. MoE agreement (llama.tiny with 4 experts, f32, TF32 off): the card
   against the CPU for ``loss_and_stats`` (loss and ``moe_drop_frac``)
   and its gradients, ``moe.apply`` in both dispatch modes at capacity
   factor 0.5 (drops) and at k=1 (out, [aux, dropped], gradients), greedy
   ``generate()`` tokens and the paged steps' logits; it prints each
   fixture's smallest top-k router margin (``moe.router_margin``), so that a
   flipped route cannot pass as noise.
11. MoE main path: the MoE flagship (``MOE_OVERRIDES``: scripts/
   sweep_moe.py's config, 1.85e9 parameters, 1.04e9 active) at full width
   and depth through the trainer CLI, B=BATCH, T=SEQ, bf16, gather
   dispatch, MOE_STEPS steps. It fails unless every loss is finite, the
   first within 1.0 of ln 32768, ``moe_drop_frac`` is reported every step
   in [0, 1), and K1-K3 each launch 8 x MOE_STEPS times, all on ``wgmma``.
   From one state and batch it then holds einsum dispatch against gather
   layer by layer (each layer's FFN input from a gather forward through
   both modes: out within BF16_REL_TOL x max|out|, [aux, dropped] equal;
   the first layer's input and routes equal between the two models'
   forwards; each layer's share of flipped top-k routes printed) and
   takes one step plain, again plain (the card's spread), with einsum
   dispatch (loss and grad_norm within MOE_DISPATCH_REL of gather, the
   worst gradient leaf within MOE_DISPATCH_GRAD_REL) and with ``--remat
   --remat-policy dots_with_no_batch_dims`` (phase 9's remat limits on
   loss, grad_norm, gradients and params). It prints the parameter counts, step_s,
   tokens/s, MFU on active FLOPs and peak memory. ``--profile`` adds one
   profiled step (``chiprun_out/chip_smoke_moe_profile.json``).
12. MoE serving: ``ServeEngine`` on the MoE flagship (full depth, bf16,
   weights from ``llama.init`` on the card), 10 seeded greedy requests
   (phase 7's 8 prompt lengths, two more sharing a 512-token prefix, the
   second sent after the first retired). It fails unless every request
   ends by length, the prefix store hits, and the pool is empty after
   drain and eviction; then phase 7's measurements (greedy agreement with
   solo ``generate()``, reported; the 8-row batch's first-decode logits
   within SERVE_LOGIT_REL x max|logit| of solo ``cached_forward``, the
   decode step's time beside its bound, which reads all four experts'
   weights; solo prefill by bucket) and the decode rows' smallest router
   margin. ``--profile`` adds one profiled decode step
   (``chiprun_out/chip_smoke_moe_serve_profile.json``).
13. oim-infer: the trainer CLI writes a llama-tiny-moe checkpoint on the
   card, ``oim_infer.main`` restores it, and its greedy rows must equal
   ``generate()`` on the restored params; a directory with no checkpoint
   must exit nonzero.
14. sources: the data plane's other sources staged through
   ``CUDABackend()`` on the card from a temporary directory (which must
   have room) and a loopback object gateway (a ThreadingHTTPServer
   answering HEAD, ranged GET and ETag, with HTTP Basic auth where an
   object asks for it), each volume >= 1 GiB (``phase_sources`` lists the
   cuts). TFRecord: 8 ImageNet-style shards of framed tf.Examples staged
   on the native engine, equal to the files on the card, walked back with
   ``iter_tfrecord_bytes`` + ``parse_example`` (count and every label as
   written), restaged as a cache hit with no plane call. webdataset by
   ``http://`` URL: 4 tar shards of ``.bin`` members of SEQ + 1 int32
   tokens, equal to the shards, the tokens recovered by ``_wds_tokens``
   equal to those written, an unchanged restage a hit, a shard whose
   bytes and ETag change a miss and a restage equal to the new bytes;
   then phase 5's Trainer for STEPS steps on those tokens with phase 5's
   checks. ceph: one 1 GiB object behind Basic auth (``CephParams``),
   equal to the object; with a wrong secret the volume ends FAILED with
   the gateway's 401 and ``memory_allocated`` is back where it was. Each
   kind prints its stage GB/s and breakdown against its bound (the slower
   of its source read alone and the pinned H2D); the ``sources`` JSON
   line carries them.
15. the main-path, serve, oim_fed, resnet, moe and sources lines and the
   kernels line (JSON), the card line, and the last line ``{"ok": true,
   "device": {...}}``. Beside the contract's keys each kernel record has
   ``oim_fed_launches`` (phase 8's launches), ``sources_launches`` (phase
   14's), ``resnet_launches`` and
   ``llama_remat_launches`` (phase 9's), ``moe_launches`` and
   ``moe_routes`` (phase 11's), ``max_abs_err_by_path`` (phase 3's
   error at each path's shape; ``max_abs_err`` is the largest), ``routes`` (the main path's
   launches by kernel route,
   e.g. ``{"wgmma": 8, "fma": 0}``), ``tflops``, ``fma_route_ms`` (the
   CUDA-core kernel on the same inputs) and ``resources`` (registers,
   spills, shared memory and blocks per SM of the route the main path
   took, from the CUDA runtime).

It refuses to run without a CUDA device, and outside a checkout of the
repository (it imports the port from the directory it sits in).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import http.server
import io
import json
import math
import os
import subprocess
import sys
import tarfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate and HBM3
# bandwidth; a bound is the larger of operations/peak and bytes/bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version: both sum in f32 and round P and dS to bf16 at
# the same points, so bf16 outputs differ by one f32 summation order
# against another (and an input to a rounding that lands on the other side
# of a bf16 step): a few bf16 ulps (2^-7 relative) of the largest value.
BF16_REL_TOL = 2.0 ** -6
F32_ABS_TOL = 1e-4  # f32 outputs (lse) and f32 odd cases

# The main path's cell: llama3-8b width, depth cut to 2 layers (the
# trainer's own dryrun cut), batch 2 x 2048 tokens, 4 steps.
LAYERS, BATCH, SEQ, STEPS = 2, 2, 2048, 4
ITERS = 10  # timed launches per kernel

KERNELS = (
    # name, TPU kernel it replaces (file:line of its pallas_call)
    ("flash_fwd", "oim_tpu/ops/attention.py:198"),
    ("flash_bwd_dkv", "oim_tpu/ops/attention.py:380"),
    ("flash_bwd_dq", "oim_tpu/ops/attention.py:418"),
)


def fail(msg: str, code: int = 1):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(code)


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exit {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms of fn() over iters launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def causal_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: bottom-right aligned causal."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(min(tk, max(0, i + off + 1)) for i in range(tq))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, got, want, tol: float, errors: list):
    err = max_err(got, want)
    ok = err <= tol and bool(got.isfinite().all())
    say(f"  {name:<26s} max_abs_err {err:.3e}  tol {tol:.3e}  {'ok' if ok else 'FAILED'}")
    if not ok:
        errors.append(f"{name}: max_abs_err {err} > {tol}")
    return err


def attention_inputs(b, tq, tk, h, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device="cuda", generator=g).to(dtype)  # noqa: E731
    return mk(b, tq, h, d), mk(b, tk, hkv, d), mk(b, tk, hkv, d), mk(b, tq, h, d)


def phase_kernels(shapes: dict, odd_cases) -> list[dict]:
    """Phase 3: the odd cases, then each driven path's attention shape
    (``shapes``: path -> (b, t, h, hkv, d), bf16 causal), each on the
    wgmma route its path's launch gate demands; returns one record per
    kernel, timed at the first path's shape."""
    import importlib

    import torch
    import torch.nn.functional as F

    from oim_tpu_torch import kernels

    # the module, not the `attention` function ops/__init__ exports
    A = importlib.import_module("oim_tpu_torch.ops.attention")

    errors: list[str] = []

    def run_case(b, tq, tk, h, hkv, d, causal, dtype, seed, lse_cotangent=False):
        q, k, v, do = attention_inputs(b, tq, tk, h, hkv, d, dtype, seed)
        scale = d ** -0.5
        ref_out, ref_lse = A.flash_forward_plain(q, k, v, causal, scale)
        # delta as the autograd Functions form it: rowsum(dO * O) in f32,
        # less the lse cotangent where lse is an output too
        delta = (do.float() * ref_out.float()).sum(-1)
        if lse_cotangent:
            g = torch.Generator(device="cuda").manual_seed(seed + 1000)
            delta = delta - torch.randn(delta.shape, device="cuda", generator=g)
        delta = delta.permute(0, 2, 1).reshape(b * h, tq).contiguous()
        ref_dk, ref_dv = A.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal, scale)
        ref_dq = A.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal, scale)
        route = kernels.bwd_route(q, k, v, do)
        rule = {"flash_fwd": kernels.fwd_route(q, k, v),
                "flash_bwd_dkv": route, "flash_bwd_dq": route}
        before = {n: dict(kernels.ROUTES[n]) for n in rule}
        out, lse = kernels.flash_fwd(q, k, v, causal, scale)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal, scale)
        dq = kernels.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
        torch.cuda.synchronize()
        for n, seen in before.items():
            took = [r for r, c in kernels.ROUTES[n].items() if c != seen[r]]
            if took != [rule[n]]:
                errors.append(f"{n} took route {took}, the rule says {rule[n]}")
        rel = BF16_REL_TOL if dtype == torch.bfloat16 else 0.0

        def tol(ref):
            return rel * float(ref.abs().max()) + (F32_ABS_TOL if rel == 0 else 0.0)

        tag = f"b{b} tq{tq} tk{tk} h{h}/{hkv} d{d} {'causal' if causal else 'full'} " \
              f"{str(dtype).removeprefix('torch.')}{' lse-cotangent' if lse_cotangent else ''}" \
              f"  K1 route {rule['flash_fwd']}, K2/K3 route {route}"
        say(f" case {tag}")
        errs = {
            "flash_fwd": max(check("K1 out", out, ref_out, tol(ref_out), errors),
                             check("K1 lse", lse, ref_lse, F32_ABS_TOL, errors)),
            "flash_bwd_dkv": max(check("K2 dk", dk, ref_dk, tol(ref_dk), errors),
                                 check("K2 dv", dv, ref_dv, tol(ref_dv), errors)),
            "flash_bwd_dq": check("K3 dq", dq, ref_dq, tol(ref_dq), errors),
        }
        return errs, (q, k, v, do, ref_out, ref_lse, delta, scale)

    for case in odd_cases:
        run_case(*case)
    if errors:
        fail("odd cases: " + "; ".join(errors))

    by_path, timed = {}, None
    for seed, (path, (b, t, h, hkv, d)) in enumerate(shapes.items(), start=1):
        say(f" {path} path's shape: q [{b},{t},{h},{d}] k/v [{b},{t},{hkv},{d}] bf16 causal")
        by_path[path], tensors = run_case(b, t, t, h, hkv, d, True, torch.bfloat16, seed)
        if kernels.bwd_route(*tensors[:4]) != "wgmma":
            errors.append(f"the {path} path's shape takes route "
                          f"{kernels.bwd_route(*tensors[:4])}, its gate wants wgmma")
        timed = timed or tensors
        del tensors
    if errors:
        fail("kernels disagree with their plain versions: " + "; ".join(errors))
    q, k, v, do, out, lse, delta, scale = timed
    b, t, h, d = q.shape
    hkv = k.shape[2]
    errs = {name: max(e[name] for e in by_path.values()) for name, _ in KERNELS}

    # Timings at the main path's shape. Plain versions repeat the kernels'
    # arithmetic in torch ops (no speed yardstick). The library yardstick:
    # scaled_dot_product_attention with an explicit bottom-right causal
    # mask on K/V expanded to q's heads (expansion outside the timing).
    group = h // hkv
    mask = A._causal_mask(t, t, q.device)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k.repeat_interleave(group, 2),
                                               v.repeat_interleave(group, 2)))
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)  # noqa: E731
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    dog = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dog,  # noqa: E731
                                          retain_graph=True)
    pairs = causal_pairs(t, t, True) * b * h
    esz = q.element_size()
    qb, kvb, rowb = q.numel() * esz, k.numel() * esz, b * h * t * 4
    fns = {
        "flash_fwd": (lambda: kernels.flash_fwd(q, k, v, True, scale),
                      lambda: A.flash_forward_plain(q, k, v, True, scale),
                      lib_fwd, 2 * 2 * d * pairs, 2 * qb + 2 * kvb + rowb),
        "flash_bwd_dkv": (lambda: kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
                          lambda: A.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale),
                          lib_bwd, 4 * 2 * d * pairs, 2 * qb + 4 * kvb + 2 * rowb),
        "flash_bwd_dq": (lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
                         lambda: A.flash_bwd_dq_plain(q, k, v, do, lse, delta, True, scale),
                         lib_bwd, 3 * 2 * d * pairs, 3 * qb + 2 * kvb + 2 * rowb),
    }
    # The first port's CUDA-core kernels on the same inputs, beside the
    # tensor-core route the rule picks here.
    earlier = {
        "flash_fwd": lambda: kernels.flash_fwd(q, k, v, True, scale, route="fma"),
        "flash_bwd_dkv": lambda: kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale,
                                                       route="fma"),
        "flash_bwd_dq": lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, True, scale,
                                                     route="fma"),
    }
    main_route = kernels.bwd_route(q, k, v, do)  # K1's too: one rule
    resources = {}
    for name in earlier:
        for r, hd in (("wgmma", 128), ("wgmma", 64), ("fma", d)):
            info = kernels.kernel_info(name, r, hd)
            if hd == d:
                resources.setdefault(name, {})[r] = info
            say(f"  {name:<14s} {r:<5s} route{f' head_dim {hd}' if r == 'wgmma' else '':<13s}: "
                f"{info['registers']} registers, {info['local_bytes']} B local (spills), "
                f"{info['smem_bytes']} B shared, {info['blocks_per_sm']} blocks per SM")
    records = []
    for name, replaces in KERNELS:
        kern, plain, lib, flops, nbytes = fns[name]
        ms = cuda_ms(kern, ITERS)
        plain_ms = cuda_ms(plain, ITERS // 4)
        ms2 = cuda_ms(kern, ITERS)  # kernel, plain, kernel: a drift shows
        library_ms = cuda_ms(lib, ITERS)
        fma_ms = cuda_ms(earlier[name], ITERS // 2)
        bound_ms, bound_by = bound(flops, nbytes)
        best = min(ms, ms2)
        say(f"  {name:<14s} kernel {ms:.3f}/{ms2:.3f} ms  plain {plain_ms:.3f} ms  "
            f"library {library_ms:.3f} ms  bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)  "
            f"{flops / (best * 1e-3) / 1e12:.1f} TFLOP/s  fma route {fma_ms:.3f} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": f"oim_tpu_torch/kernels/csrc/{kernels.SOURCES[name]}",
            "replaces": replaces, "launches": None, "max_abs_err": errs[name],
            "max_abs_err_by_path": {path: e[name] for path, e in by_path.items()},
            "ms": best, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "routes": None,
            "tflops": flops / (best * 1e-3) / 1e12, "fma_route_ms": fma_ms,
            "resources": resources[name][main_route],
            "library": ("scaled_dot_product_attention forward, explicit bottom-right mask"
                        if name == "flash_fwd" else
                        "scaled_dot_product_attention backward (dq, dk and dv in one call), "
                        "explicit bottom-right mask"),
        })
    del lib_out
    torch.cuda.empty_cache()
    return records


def build_read_engine() -> dict:
    """Phase 2's second half: the C++ read engine compiled from
    ``native/staging.cc`` into ``oim_tpu_torch/data/build/`` and loaded."""
    from oim_tpu_torch.data import staging

    cxx = staging.compiler()
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError) as e:
        fail(f"the read engine's compiler {cxx!r} does not run: {e}")
    jpeg = staging.has_jpeg()
    t0 = time.monotonic()
    try:
        lib = staging.build()
    except staging.StagingError as e:
        fail(f"the native read engine did not build: {e}")
    build_s = time.monotonic() - t0
    if staging.native_lib() is None:
        fail(f"the native read engine at {lib} does not load")
    say(f"  read engine: {lib.relative_to(ROOT)} from native/staging.cc in {build_s:.1f} s "
        f"({version}; libjpeg {'found: -ljpeg' if jpeg else 'not found: no JPEG decoder'})")
    return {"path": str(lib.relative_to(ROOT)), "compiler": version, "libjpeg": jpeg,
            "build_s": build_s}


def phase_agreement():
    """Phase 4: llama.tiny on the card against the same model on the CPU."""
    import dataclasses

    import torch

    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train.state import tree_leaves

    cfg = dataclasses.replace(llama.tiny(), vocab_chunk=96)
    params = llama.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 130), generator=torch.Generator().manual_seed(1))
    results = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({n: w.detach().to(dev) for n, w in v.items()} if isinstance(v, dict)
                 else v.detach().to(dev)) for k, v in params.items()}
        leaves = list(tree_leaves(p))
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = llama.loss_and_stats(p, tokens.to(dev), cfg)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        results[dev] = (loss.item(), [g.detach().cpu() for g in grads])
    loss_err = abs(results["cpu"][0] - results["cuda"][0])
    grad_err = max(max_err(a, b) for a, b in zip(results["cpu"][1], results["cuda"][1]))
    say(f"  llama.tiny f32 (T=129, ragged tiles): loss cpu {results['cpu'][0]:.6f} "
        f"cuda {results['cuda'][0]:.6f} |diff| {loss_err:.2e}; grads max |diff| {grad_err:.2e}")
    if not (loss_err <= 1e-4 and grad_err <= 1e-4 and math.isfinite(results["cuda"][0])):
        fail(f"llama.tiny on the card disagrees with the CPU: loss {loss_err}, grads {grad_err}")


def main_path_argv() -> list[str]:
    return ["--model", "llama3-8b", "--override", f"n_layers={LAYERS}",
            "--steps", str(STEPS), "--batch-size", str(BATCH), "--seq-len", str(SEQ),
            "--warmup-steps", "2", "--log-every", "1", "--log-level", "info"]


def phase_main_path(profile: bool) -> dict:
    """Phase 5: the CLI's Trainer at llama3-8b width."""
    layers, steps, batch, seq = LAYERS, STEPS, BATCH, SEQ
    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.models import llama

    argv = main_path_argv()
    say(f"  python -m oim_tpu_torch.cli.oim_trainer {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.monotonic()
    trainer = oim_trainer.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hist = trainer.history
    losses = [r["loss"] for r in hist]
    mcfg = trainer.cfg.model_config()
    say(f"  losses {losses}")
    say(f"  launches {launches}  (want {layers} x {steps} = {layers * steps} each)")
    say(f"  routes {routes}  (want every launch on wgmma)")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"main path: losses not finite or missing: {losses}")
    if abs(losses[0] - math.log(mcfg.vocab)) > 1.0:
        fail(f"main path: first loss {losses[0]} not near ln(vocab) {math.log(mcfg.vocab):.3f}")
    for name, _ in KERNELS:
        if launches[name] != layers * steps:
            fail(f"main path: {name} launched {launches[name]} times, "
                 f"want {layers * steps}")
    for name, _ in KERNELS:
        if routes[name]["wgmma"] != layers * steps:
            fail(f"main path: {name} took routes {routes[name]}, want all "
                 f"{layers * steps} on wgmma")
    steady = hist[1:] if len(hist) > 1 else hist
    step_s = sum(r["step_s"] for r in steady) / len(steady)
    tokens = batch * seq
    mfu = sum(r["mfu"] for r in steady) / len(steady)
    say(f"  step_s {step_s:.4f} (steps 2..{steps}; step 1 {hist[0]['step_s']:.4f})  "
        f"tokens/s {tokens / step_s:.0f}  MFU {mfu:.4f} of 989e12  "
        f"params {llama.num_params(mcfg) / 1e9:.3f}e9  peak mem {peak_gb:.1f} GB  "
        f"wall {wall:.1f} s")
    result = {"launches": launches, "routes": routes, "step_s": step_s, "mfu": mfu,
              "losses": losses, "tokens_per_s": tokens / step_s, "peak_mem_gb": peak_gb}
    if profile:
        result["profile"] = profile_step(trainer)
    return result


def _category(kernel: str) -> str:
    name = kernel.lower()
    if "oimflash" in name:
        return "attention kernels (K1-K3)"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmuls (cuBLAS)"
    if "reduce" in name or "norm" in name:
        return "reductions"
    if any(k in name for k in ("index", "scatter", "gather", "embedding")):
        return "index, gather and scatter (embedding, MoE dispatch)"
    return "elementwise and copies"


OPTIMIZER_RANGE = "optimizer (AdamW)"


@contextlib.contextmanager
def patched(owner, attr: str, wrap):
    """Within the block, ``owner.attr`` is ``wrap(the original)``."""
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def in_range(name: str):
    """A ``patched`` wrap: every call runs under a record_function range."""
    from torch.profiler import record_function

    def wrap(fn):
        def ranged(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return ranged
    return wrap


def moe_calls(calls: list):
    """A ``patched`` wrap for ``moe.apply``: each call appends (its layer's
    MoE params, its input detached, its MoEConfig) to ``calls`` first."""
    def wrap(apply):
        def spy(params, x, cfg, with_stats=False):
            calls.append((params, x.detach(), cfg))
            return apply(params, x, cfg, with_stats)
        return spy
    return wrap


def profiled_train_step(trainer, batch):
    """One more step of ``trainer`` on ``batch`` under torch.profiler, the
    optimizer under OPTIMIZER_RANGE; returns (profiler, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with patched(trainer.tx, "update", in_range(OPTIMIZER_RANGE)), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        trainer.state, stats = trainer.step_fn(trainer.state, batch)
        float(stats["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    return prof, wall_ms


def profile_step(trainer, name: str = "chip_smoke_profile.json") -> dict:
    """One more step under torch.profiler: device time by kernel and by
    category, the optimizer's share (the kernels under its range), the idle
    share of the step's wall time; the table is written to
    chiprun_out/``name``."""
    from oim_tpu_torch.train.trainer import synthetic_batches

    batch = trainer.place_batch(next(synthetic_batches(trainer.cfg)))
    prof, wall_ms = profiled_train_step(trainer, batch)
    # Device-side events only (kernels, memcpy/memset): CPU-side ops carry
    # their children's device time too and would count it twice. The
    # optimizer's range is an annotation row, not a kernel.
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
                   and ev.key != OPTIMIZER_RANGE),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    cats: dict[str, float] = {}
    for key, ms, _ in rows:
        cats[_category(key)] = cats.get(_category(key), 0.0) + ms
    optimizer_ms = device_ms_by_category(prof, (OPTIMIZER_RANGE,), (), "rest").get(
        OPTIMIZER_RANGE, 0.0)
    say(f"  profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}; the optimizer's kernels "
        f"{optimizer_ms:.1f} ms ({optimizer_ms / busy:.1%}), forward and backward the rest")
    for cat, ms in sorted(cats.items(), key=lambda c: -c[1]):
        say(f"    {ms:9.3f} ms  {ms / busy:6.1%}  {cat}")
    for key, ms, count in rows[:12]:
        say(f"    {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    result = {"wall_ms": wall_ms, "busy_ms": busy, "optimizer_ms": optimizer_ms,
              "categories": cats, "rows": rows}
    (out / name).write_text(json.dumps(result, indent=1))
    return result


# -- serving (phases 6-7) ------------------------------------------------

SERVE_TINY_TOL = 1e-4        # f32 logits, card against CPU, TF32 off
# bf16 first-decode logits of the paged batch against solo cached_forward,
# as max|diff| / max|logit|. Solo at batch 2 against batch 1 (the same
# dense path at another product shape) reads up to ~0.021 on the H100 and
# the paged batch up to ~0.019; a page, offset or mask fault reads O(1).
SERVE_LOGIT_REL = 2.0 ** -4
SERVE_LENGTHS = (17, 48, 64, 200, 333, 700, 1000, 1500)
SERVE_PREFIX, SERVE_TAILS = 512, (130, 7, 40, 95)
SERVE_CANCEL, SERVE_CANCEL_AFTER = "len700", 8
SERVE_ALONE, SERVE_PROMOTED = "prefix+130", "prefix+7"
PREFILL_BUCKETS = (64, 512, 1024, 2048)
SERVE_ENGINE = dict(max_batch=8, max_seq=2048, queue_depth=16, prefix_block=16,
                    prefix_cache_bytes=1 << 30, kv_host_bytes=1 << 30)
RESULT_TIMEOUT = 600.0


def pct(xs, q: float):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def first_divergence(a, b) -> int:
    """How many leading tokens two streams share."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def run_requests(eng, reqs):
    """Submit every request at once and collect the streams; fails on
    anything but a full-length finish."""
    handles = [eng.submit(p, max_new=n, temperature=t, seed=s) for p, n, t, s in reqs]
    outs = [h.result(timeout=RESULT_TIMEOUT) for h in handles]
    for (p, n, _, _), h, out in zip(reqs, handles, outs):
        if h.finish_reason != "length" or len(out) != n:
            fail(f"serving: request of {len(p)} tokens ended {h.finish_reason!r} after "
                 f"{len(out)} of {n} tokens; engine error: {eng.error}")
    return outs


def check_paged_steps(cfg, host, device, errors: list) -> None:
    """``prefill_into_pages`` (two rows), ``decode_step`` and
    ``verify_step`` logits of the weights ``host`` (numpy) on the card
    against the CPU, within SERVE_TINY_TOL."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import llama

    page, g = 4, torch.Generator().manual_seed(1)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in (9, 5)]
    cand = torch.randint(0, cfg.vocab, (2, 4), generator=g)
    pos = torch.tensor([9, 5])

    def steps(dev):
        p, pool = llama.from_numpy(host, dev), gen.init_page_pool(cfg, 9, page, device=dev)
        outs = []
        for row, prompt in enumerate(prompts):
            padded = torch.zeros(1, 16, dtype=torch.long)
            padded[0, :len(prompt)] = prompt
            outs.append(gen.prefill_into_pages(p, padded.to(dev), len(prompt), pool,
                                               tables[row].to(dev), 0, cfg, page)[0])
        outs.append(gen.decode_step(p, cand[:, 0].to(dev), pool, tables.to(dev),
                                    pos.to(dev), cfg, page)[0])
        outs.append(gen.verify_step(p, cand.to(dev), pool, tables.to(dev),
                                    (pos + 1).to(dev), cfg, page)[0])
        return [o.cpu() for o in outs]

    for name, a, b in zip(("prefill_into_pages row 0", "prefill_into_pages row 1",
                           "decode_step", "verify_step"), steps(device), steps("cpu")):
        check(name, a, b, SERVE_TINY_TOL, errors)


def phase_serve_agreement(device="cuda"):
    """Phase 6: llama.tiny (f32) through the serving path on the card
    against the CPU and against itself."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.serve import ServeEngine, kvtier

    cfg = llama.tiny(vocab=64, dim=32, n_layers=2)
    host = llama.to_numpy(llama.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    errors = []
    check_paged_steps(cfg, host, device, errors)
    if errors:
        fail("serving steps on the card disagree with the CPU: " + "; ".join(errors))

    params = llama.from_numpy(host, device)
    rs = np.random.RandomState(3)
    shared = rs.randint(0, cfg.vocab, 8).tolist()
    reqs = [(rs.randint(0, cfg.vocab, n).tolist(), 12, 0.0, i)
            for i, n in enumerate((3, 17, 1, 30))]
    reqs += [(shared + [i], 10, 0.0, 9) for i in range(3)]
    engine_kw = dict(max_batch=4, max_seq=64, prefix_block=4, device=device)

    def run(eng):
        # The shared-prefix requests one at a time: the 2nd and 3rd hit.
        return run_requests(eng, reqs[:4]) + [run_requests(eng, [r])[0] for r in reqs[4:]]

    eng = ServeEngine(params, cfg, **engine_kw)
    plain = run(eng)
    hits = eng.stats()["prefix_hits"]
    eng.stop()
    solo = [gen.generate(params, torch.tensor([p], device=device), n, cfg,
                         max_seq=64)[0, len(p):].tolist() for p, n, _, _ in reqs]
    eng = ServeEngine(params, cfg, draft_params=params, draft_cfg=cfg, spec_tokens=3,
                      **engine_kw)
    spec = run(eng)
    spec_stats = eng.stats()
    eng.stop()
    say(f"  engine greedy streams equal to solo generate() on the card: "
        f"{sum(a == b for a, b in zip(plain, solo))}/{len(reqs)}  (prefix hits {hits})")
    say(f"  self-draft spec engine greedy streams equal to the plain engine's: "
        f"{sum(a == b for a, b in zip(spec, plain))}/{len(reqs)}  "
        f"(accepted {spec_stats['spec_accepted']} of {spec_stats['spec_proposed']})")
    if plain != solo or hits != 2:
        fail(f"serving: engine greedy streams differ from solo generate() or the prefix "
             f"store missed ({hits} hits, want 2): {plain} vs {solo}")
    if spec != plain or not spec_stats["spec_accepted"]:
        fail(f"serving: spec streams differ from plain or accepted nothing: {spec} vs {plain}")

    gb = torch.Generator(device=device).manual_seed(2)
    pool = {n: torch.randn(2, 6, 16, 8, 128, generator=gb, device=device).to(torch.bfloat16)
            for n in ("k", "v")}
    before = {n: t[:, 3].cpu().view(torch.int16) for n, t in pool.items()}
    k, v = kvtier.page_kv(pool, 3)
    kvtier.stage_page(pool, 5, k, v)
    exact = (k.tobytes() == before["k"].numpy().tobytes()
             and v.tobytes() == before["v"].numpy().tobytes()
             and all(torch.equal(pool[n][:, 5].cpu().view(torch.int16), before[n])
                     for n in ("k", "v")))
    say(f"  host tier: bf16 page demoted (pinned D2H) and promoted (pinned H2D): "
        f"{'bit-exact' if exact else 'DIFFERS'}")
    if not exact:
        fail("serving: the host-tier round trip changed a page's bytes")


def serve_traffic(vocab: int, seed: int = 0) -> list[dict]:
    """The main path's 12 requests: 8 prompts of SERVE_LENGTHS tokens and 4
    sharing one SERVE_PREFIX-token prefix; every other one sampled."""
    rs = np.random.RandomState(seed)
    reqs = [{"name": f"len{n}", "prompt": rs.randint(0, vocab, n).tolist(),
             "max_new": 128 if n == 1500 else 64,
             "temperature": 0.0 if i % 2 == 0 else 0.8, "seed": 100 + i}
            for i, n in enumerate(SERVE_LENGTHS)]
    prefix = rs.randint(0, vocab, SERVE_PREFIX).tolist()
    reqs += [{"name": f"prefix+{t}", "prompt": prefix + rs.randint(0, vocab, t).tolist(),
              "max_new": 64, "temperature": 0.8 if j in (0, 3) else 0.0, "seed": 200 + j,
              "shared": True}
             for j, t in enumerate(SERVE_TAILS)]
    return reqs


def _submit(eng, r):
    return eng.submit(r["prompt"], max_new=r["max_new"], temperature=r["temperature"],
                      seed=r["seed"])


def phase_serve_main(cfg, params, device="cuda", profile=False) -> dict:
    """Phase 7: the engine at the cell's width and depth, then the
    measurements, then speculation."""
    import gc
    import threading

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.serve import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    eng = ServeEngine(params, cfg, device=device, **SERVE_ENGINE)
    reqs = serve_traffic(cfg.vocab)
    by = {r["name"]: r for r in reqs}
    t0 = time.monotonic()
    alone = by[SERVE_ALONE]
    alone["handle"] = _submit(eng, alone)
    alone["out"] = alone["handle"].result(timeout=RESULT_TIMEOUT)
    rest = [r for r in reqs if r is not alone]
    for r in rest:
        r["handle"] = _submit(eng, r)

    def cancel_after(r):
        out = []
        for tok in r["handle"].tokens(timeout=RESULT_TIMEOUT):
            out.append(tok)
            if len(out) == SERVE_CANCEL_AFTER:
                r["handle"].cancel()
        r["out"] = out

    watcher = threading.Thread(target=cancel_after, args=(by[SERVE_CANCEL],))
    watcher.start()
    for r in rest:
        if r["name"] != SERVE_CANCEL:
            r["out"] = r["handle"].result(timeout=RESULT_TIMEOUT)
    watcher.join(RESULT_TIMEOUT)
    wall = time.monotonic() - t0
    stats = eng.stats()
    if eng.error:
        fail(f"serving: the engine thread died:\n{eng.error}")
    for r in reqs:
        h, want = r["handle"], ("cancelled" if r["name"] == SERVE_CANCEL else "length")
        ok = h.finish_reason == want and (want == "cancelled" or len(r["out"]) == r["max_new"])
        say(f"  {r['name']:<11s} prompt {len(r['prompt']):5d}  "
            f"{'sampled t=0.8' if r['temperature'] else 'greedy       '}  "
            f"{len(r['out']):3d}/{r['max_new']} tokens  {h.finish_reason:<9s}  "
            f"prefix {h.stats['prefix_tokens']:4d}  first token "
            f"{h.stats['first_token_s'] * 1e3:8.1f} ms")
        if not ok:
            fail(f"serving: {r['name']} ended {h.finish_reason!r} with {len(r['out'])} "
                 f"tokens, want {want!r} with {r['max_new']}")
    say(f"  prefix hits {stats['prefix_hits']}, prefill tokens from the store "
        f"{stats['prefill_tokens_cached']}, computed {stats['prefill_tokens_computed']}; "
        f"{stats['decode_tokens']} decode tokens in {stats['target_steps']} steps, "
        f"wall {wall:.2f} s")
    n_hits = len(SERVE_TAILS) - 1
    if (stats["prefix_hits"], stats["prefill_tokens_cached"]) != (n_hits, n_hits * SERVE_PREFIX):
        fail(f"serving: want {n_hits} prefix hits saving {n_hits * SERVE_PREFIX} tokens, got "
             f"{stats['prefix_hits']} and {stats['prefill_tokens_cached']}")

    freed = eng.evict_prefix_store()  # the engine is idle: every request ended
    host = eng.host_stats()
    again = by[SERVE_PROMOTED]
    h = _submit(eng, again)
    out = h.result(timeout=RESULT_TIMEOUT)
    host_after = eng.host_stats()
    promoted = host_after["promotions"] - host["promotions"]
    say(f"  host tier: evicting the store freed {freed} pages into {host['entries']} host "
        f"blocks ({host['bytes'] / 2**20:.0f} MiB); {SERVE_PROMOTED} again: {promoted} "
        f"blocks promoted, prefix {h.stats['prefix_tokens']} tokens, first token "
        f"{h.stats['first_token_s'] * 1e3:.1f} ms, stream "
        f"{'equal to' if out == again['out'] else 'DIFFERENT from'} its first run")
    if (out != again["out"] or h.stats["prefix_tokens"] != SERVE_PREFIX
            or promoted < SERVE_PREFIX // SERVE_ENGINE["prefix_block"]):
        fail("serving: the request promoted from the host tier did not repeat its first run")
    eng.stop(drain=True)
    eng.evict_prefix_store()
    eng.evict_host_tier()
    used = eng.pool_stats()["used_pages"]
    say(f"  after drain and eviction: {used} pages used")
    if used:
        fail(f"serving: {used} pages leaked past drain and eviction")

    # One burst of 12 requests is a functional smoke, not a load: its
    # percentiles (a few samples, queue order decides them) are smoke
    # readings, kept apart from the measurements and not for comparison.
    misses = [r["handle"].stats["first_token_s"] * 1e3 for r in rest if not r.get("shared")]
    hits = [r["handle"].stats["first_token_s"] * 1e3 for r in rest if r.get("shared")]
    gaps = [g * 1e3 for r in reqs for g in r["handle"].stats["inter_token_s"]]
    result = {
        "model": "llama3-8b" if cfg.dim == 4096 else f"dim {cfg.dim}",
        "layers": cfg.n_layers, "requests": len(reqs), "engine": SERVE_ENGINE,
        "wall_s": wall, "prefix_hits": stats["prefix_hits"],
        "prefill_tokens_cached": stats["prefill_tokens_cached"],
        "decode_tokens": stats["decode_tokens"], "target_steps": stats["target_steps"],
        "first_token_alone_ms": {
            "miss": alone["handle"].stats["first_token_s"] * 1e3,
            "host_promoted_hit": h.stats["first_token_s"] * 1e3},
        "burst_smoke_not_for_comparison": {
            "first_token_miss_p50_ms": pct(misses, 0.5), "n_miss": len(misses),
            "first_token_hit_p50_ms": pct(hits, 0.5), "n_hit": len(hits),
            "inter_token_p50_ms": pct(gaps, 0.5), "inter_token_p99_ms": pct(gaps, 0.99),
            "n_gaps": len(gaps)},
    }
    smoke = result["burst_smoke_not_for_comparison"]
    say(f"  first token, one request on an idle engine: miss ({len(alone['prompt'])} tokens) "
        f"{result['first_token_alone_ms']['miss']:.1f} ms, host-tier hit "
        f"{result['first_token_alone_ms']['host_promoted_hit']:.1f} ms")
    say(f"  burst smoke readings (12 requests at once; not a load measurement): first "
        f"token miss p50 {smoke['first_token_miss_p50_ms']:.1f} ms over {len(misses)}, "
        f"hit p50 {smoke['first_token_hit_p50_ms']:.1f} ms over {len(hits)} (queue wait "
        f"included); inter-token p50 {smoke['inter_token_p50_ms']:.2f} ms, p99 "
        f"{smoke['inter_token_p99_ms']:.2f} ms over {len(gaps)} gaps")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    result.update(serve_measure(cfg, params, reqs, device, profile))

    spec_names = [r["name"] for r in reqs if not r["temperature"] and not r.get("shared")]
    eng = ServeEngine(params, cfg, device=device, max_batch=8, max_seq=2048, queue_depth=16,
                      draft_params=params, draft_cfg=cfg, spec_tokens=4)
    outs = run_requests(eng, [(by[n]["prompt"], by[n]["max_new"], 0.0, 0) for n in spec_names])
    st = eng.stats()
    eng.stop()
    # Tokens a live row gains per target forward: 1 for plain decode.
    tpts = st["decode_tokens"] / max(st["decode_row_steps"], 1)
    same = [first_divergence(o, by[n]["out"]) for n, o in zip(spec_names, outs)]
    say(f"  speculation (self-draft, spec_tokens 4, {len(spec_names)} greedy requests): "
        f"acceptance {st['spec_accept_rate']}, {tpts:.2f} tokens per row per target step "
        f"({st['decode_tokens']} tokens in {st['target_steps']} steps, "
        f"{st['decode_row_steps']} row-steps); tokens equal to the plain engine's before "
        f"the first divergence: {same}")
    if not (st["spec_accept_rate"] or 0) > 0 or not tpts > 1:
        fail(f"serving: speculation accepted nothing ({st})")
    result["spec"] = {"accept_rate": st["spec_accept_rate"], "tokens_per_target_step": tpts,
                      "equal_to_plain_prefix": same}
    del eng
    gc.collect()
    result["kernel_launches"] = dict(kernels.LAUNCHES)
    result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"  peak memory {result['peak_mem_gb']:.1f} GB; kernel launches on the "
        f"serving path {result['kernel_launches']} (no kernel of the port is on it)")
    return result


def serve_measure(cfg, params, reqs, device, profile, moe_inputs: list | None = None,
                  profile_name: str = "chip_smoke_serve_profile.json") -> dict:
    """Solo generate() against the engine's greedy streams; an 8-row paged
    batch (the 8 prompts of SERVE_LENGTHS): first-decode logits against
    solo, the decode step's time and bound, solo prefill by bucket, and
    (``profile``) one profiled decode step. ``moe_inputs`` (a list) takes
    the batch's first decode step's ``moe_calls``."""
    import contextlib

    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import moe
    from oim_tpu_torch.train.state import tree_leaves

    agree = {}
    for r in reqs:
        if r["temperature"] == 0 and r["name"] != SERVE_CANCEL:
            solo = gen.generate(params, torch.tensor([r["prompt"]], device=device),
                                r["max_new"], cfg)[0, len(r["prompt"]):].tolist()
            agree[r["name"]] = first_divergence(solo, r["out"])
    say(f"  greedy tokens equal to solo generate() before the first divergence: {agree} "
        f"(reported: bf16 products at other shapes round differently)")

    page, rows = SERVE_ENGINE["prefix_block"], [r for r in reqs if not r.get("shared")]
    n_blocks = SERVE_ENGINE["max_seq"] // page
    pool = gen.init_page_pool(cfg, len(rows) * n_blocks + 1, page, device=device)
    tables = torch.zeros(len(rows), n_blocks, dtype=torch.long)
    firsts = []
    for b, r in enumerate(rows):
        n = len(r["prompt"])
        tables[b, :-(-(n + 1) // page)] = torch.arange(-(-(n + 1) // page)) + 1 + b * n_blocks
        padded = torch.zeros(1, max(8, 1 << (n - 1).bit_length()), dtype=torch.long)
        padded[0, :n] = torch.tensor(r["prompt"])
        last, _ = gen.prefill_into_pages(params, padded.to(device), n, pool,
                                         tables[b].to(device), 0, cfg, page)
        firsts.append(int(last.argmax()))
    tables = tables.to(device)
    tokens = torch.tensor(firsts, device=device)
    pos = torch.tensor([len(r["prompt"]) for r in rows], device=device)
    with (contextlib.nullcontext() if moe_inputs is None
          else patched(moe, "apply", moe_calls(moe_inputs))):
        logits, _ = gen.decode_step(params, tokens, pool, tables, pos, cfg, page)
    errs, floor = {}, {}

    def solo_decode(prompt, tok, batch):
        n = len(prompt)
        cache = gen.init_cache(cfg, batch, n + 1, device=device)
        gen.cached_forward(params, torch.tensor([prompt] * batch, device=device), cache,
                           0, cfg)
        return gen.cached_forward(params, tok.expand(batch, 1), cache, n, cfg)[0][0, -1]

    for b, r in enumerate(rows):
        want = solo_decode(r["prompt"], tokens[b:b + 1, None], 1)
        # The noise floor: the same dense path with the prompt twice in
        # the batch (other product shapes, so other bf16 roundings).
        twin = solo_decode(r["prompt"], tokens[b:b + 1, None], 2)
        errs[r["name"]] = float((logits[b] - want).abs().max() / want.abs().max())
        floor[r["name"]] = float((twin - want).abs().max() / want.abs().max())
    say(f"  first decode step, 8 paged rows against solo cached_forward: max|diff| / "
        f"max|logit| {({k: round(v, 5) for k, v in errs.items()})} (limit "
        f"{SERVE_LOGIT_REL:.4f}); solo at batch 2 against batch 1, the same "
        f"measure: {({k: round(v, 5) for k, v in floor.items()})}")
    bad = {k: v for k, v in errs.items() if not v <= SERVE_LOGIT_REL}
    if bad:
        fail(f"serving: the paged batch's first-decode logits differ from solo "
             f"cached_forward beyond {SERVE_LOGIT_REL} x max|logit|: {bad}")

    temps = torch.tensor([r["temperature"] for r in rows], device=device)
    uniforms = torch.full((len(rows),), 0.5, device=device)

    def step():
        return gen.sample(gen.decode_step(params, tokens, pool, tables, pos, cfg, page)[0],
                          temps, uniforms)

    step_ms = cuda_ms(step, 10)
    # The bytes the step must read: every weight but the embedding table,
    # of which the lookup reads one row per token, and the K/V the rows'
    # positions hold (with the one each writes).
    embed = params["embed"]
    weight_bytes = (sum(t.numel() * t.element_size() for t in tree_leaves(params))
                    - embed.numel() * embed.element_size()
                    + len(rows) * cfg.dim * embed.element_size())
    kv_bytes = int(sum(int(p) + 1 for p in pos) * 2 * cfg.n_layers * cfg.kv_dim
                   * cfg.dtype.itemsize)
    bound = (weight_bytes + kv_bytes) / PEAK_HBM_BYTES * 1e3
    say(f"  decode step, 8 rows at {[int(p) for p in pos]} (mean context "
        f"{float(pos.float().mean()):.0f}): {step_ms:.2f} ms, "
        f"{len(rows) / step_ms * 1e3:.0f} tokens/s; bound {bound:.2f} ms (bytes: "
        f"{weight_bytes / 1e9:.3f} GB of weights read (8 embedding rows) + "
        f"{kv_bytes / 1e9:.3f} GB K/V at 3.35e12 B/s), {step_ms / bound:.1f}x the bound")
    profiled = profile_decode(step, profile_name) if profile else None
    prefill = {}
    for T in PREFILL_BUCKETS:
        toks = torch.randint(0, cfg.vocab, (1, T), device=device)
        table = tables[0].clone()
        table[:T // page] = torch.arange(T // page, device=device) + 1
        prefill[T] = cuda_ms(lambda: gen.prefill_into_pages(
            params, toks, T, pool, table, 0, cfg, page), 3)
    say("  solo prefill: " + ", ".join(f"{T} tokens {ms:.1f} ms ({T / ms * 1e3:.0f} tokens/s)"
                                       for T, ms in prefill.items()))
    out = {"greedy_equal_prefix": agree, "first_decode_logit_rel_err": errs,
           "first_decode_logit_rel_err_batch2_solo": floor,
           "decode_step_ms": step_ms, "decode_tokens_per_s": len(rows) / step_ms * 1e3,
           "decode_bound_ms": bound, "decode_positions": [int(p) for p in pos],
           "prefill_ms": prefill}
    if profiled is not None:
        out["profile"] = profiled
        # The profiled window's wall carries the profiler's host work; the
        # same busy time over the step's CUDA-event time is the idle share
        # of an unprofiled step.
        out["decode_idle_share"] = max(0.0, 1 - profiled["busy_ms"] / step_ms)
        say(f"  decode step idle share without the profiler: device busy "
            f"{profiled['busy_ms']:.2f} of {step_ms:.2f} ms -> {out['decode_idle_share']:.3f}; "
            f"{step_ms * 1e3 / max(profiled['aten_ops'], 1):.1f} us of step per aten op")
    return out


SERVE_CATEGORIES = (
    ("matmuls (projections, lm_head)", ("aten::mm", "aten::addmm")),
    ("page-table gather and copies", ("aten::index", "aten::index_put_",
                                      "aten::_index_put_impl_", "aten::copy_",
                                      "aten::clone", "aten::contiguous")),
    ("cache attention (scores, mask, softmax, PV)", ("aten::bmm", "aten::_softmax",
                                                     "aten::masked_fill_",
                                                     "aten::masked_fill")),
)


def device_ms_by_category(prof, ranges, categories, default) -> dict[str, float]:
    """Device ms of every kernel, charged to the host op that launched it:
    to the innermost enclosing ``record_function`` range named in
    ``ranges``, else to the first category listing the op's name, else to
    ``default``."""
    cats: dict[str, float] = {}
    for ev in prof.events():
        ms = getattr(ev, "self_device_time_total", 0) / 1e3
        if str(ev.device_type).endswith("CUDA") or ms <= 0:
            continue
        p = ev
        while p is not None and p.name not in ranges:
            p = p.cpu_parent
        cat = p.name if p is not None else next(
            (c for c, ops in categories if ev.name in ops), default)
        cats[cat] = cats.get(cat, 0.0) + ms
    return cats


MOE_RANGE = "MoE FFN (router, dispatch, experts, combine)"


def profile_decode(step, name: str = "chip_smoke_serve_profile.json") -> dict:
    """One 8-row decode step (with sampling) under torch.profiler: device ms
    by category, each kernel charged to the op that launched it (sampling
    and an MoE model's FFN: everything under their ranges), and the idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import moe

    torch.cuda.synchronize()
    with patched(gen, "sample", in_range("sampling")), \
            patched(moe, "apply", in_range(MOE_RANGE)), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step().cpu()
        wall_ms = (time.monotonic() - t0) * 1e3
    # The ranges show on the device timeline too, as annotation rows: not
    # kernels, so left out of the busy time.
    kernels_ = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
                for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
                and ev.key not in ("sampling", MOE_RANGE)]
    busy = sum(k[1] for k in kernels_)
    cats = device_ms_by_category(prof, ("sampling", MOE_RANGE), SERVE_CATEGORIES,
                                 "elementwise and other")
    attributed = sum(cats.values())
    if busy > attributed + 1e-3:
        cats["not attributed to an op"] = busy - attributed
    idle = max(0.0, 1 - busy / wall_ms) if wall_ms else None
    launches = sum(k[2] for k in kernels_)
    ops = sum(1 for ev in prof.events()
              if ev.cpu_parent is None and ev.name.startswith("aten::"))
    say(f"  profiled decode step: wall {wall_ms:.2f} ms (the profiler's own host work "
        f"included), device busy {busy:.2f} ms, idle share {idle:.3f}; {launches} kernel "
        f"launches from {ops} top-level aten ops")
    for cat, ms in sorted(cats.items(), key=lambda c: -c[1]):
        say(f"    {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}  {cat}")
    for key, ms, count in sorted(kernels_, key=lambda k: -k[1])[:12]:
        say(f"    {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    result = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": idle,
              "kernel_launches": launches, "aten_ops": ops,
              "categories": cats, "kernels": kernels_}
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / name).write_text(json.dumps(result, indent=1))
    return result


# -- OIM-fed training (phase 8) ------------------------------------------

FED_TOKENS = 1 << 30          # int32 tokens: a 4 GiB, ~1 B-token pretraining shard
FED_CHUNK = 64 << 20          # the backend's staging chunk
FED_CACHE = 8 << 30           # stage-cache capacity (the 1 GiB default would skip it)
FED_BLOCK = 1 << 26           # tokens per block written and compared (256 MiB)
FED_CANCEL_AT = 1 << 30       # landed bytes at which phase 8 unstages a stage


def write_token_volume(path: str, n_tokens: int, vocab: int, seed: int = 0) -> None:
    """An int32 .npy of n_tokens in [0, vocab) from a seeded generator,
    written block by block and synced to the disk, so that no writeback of
    its pages runs beside the reads timed after it (they stay cached)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<i4", "fortran_order": False, "shape": (n_tokens,)})
        for a in range(0, n_tokens, FED_BLOCK):
            rng.integers(0, vocab, min(FED_BLOCK, n_tokens - a), dtype=np.int32).tofile(f)
        f.flush()
        os.fsync(f.fileno())


def check_volume_bytes(arr, path: str) -> None:
    """The staged tensor against the file, block by block on the card."""
    import torch

    mm = np.load(path, mmap_mode="r")
    if tuple(arr.shape) != mm.shape or arr.dtype != torch.int32:
        fail(f"oim-fed: staged {tuple(arr.shape)} {arr.dtype}, the file holds "
             f"{mm.shape} {mm.dtype}")
    for a in range(0, mm.shape[0], FED_BLOCK):
        want = torch.from_numpy(np.array(mm[a:a + FED_BLOCK])).to(arr.device)
        got = arr[a:a + FED_BLOCK]
        if not torch.equal(got, want):
            first = a + int((got != want).nonzero()[0, 0])
            fail(f"oim-fed: staged token {first} is {int(arr[first])}, the file has "
                 f"{int(mm[first])}")


def h2d_gbps() -> float:
    """One pinned FED_CHUNK copy to the card, by CUDA events: the H2D half
    of a stage timed alone."""
    import torch

    pinned = torch.empty(FED_CHUNK, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(FED_CHUNK, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(pinned, non_blocking=True), 20, warmup=2)
    return FED_CHUNK / (ms * 1e-3) / 1e9


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    if a.size % 8 == 0 and a.ctypes.data % 8 == 0 and b.ctypes.data % 8 == 0:
        a, b = a.view(np.uint64), b.view(np.uint64)
    return bool(np.array_equal(a, b))


def time_read_engines(path: str, payload: int, nbytes: int) -> tuple[dict, dict]:
    """The read half of a stage timed alone, by engine: ``nbytes`` of
    ``path`` from ``payload`` on, read in FED_CHUNK pieces into one
    torch-pinned FED_CHUNK buffer (host clock around each read only), in
    two rounds, the second in the reverse order of the first, so that no
    engine always reads first. Each piece is compared with the file after
    its read, untimed. An engine this host refuses is recorded as
    "unavailable: <reason>", never timed under another's name. Returns
    GB/s by engine (the mean of the rounds, or the reason) and each
    round's GB/s by engine."""
    import torch

    from oim_tpu_torch.data import staging

    buf = torch.empty(FED_CHUNK, dtype=torch.uint8, pin_memory=True).numpy()
    mm = np.memmap(path, np.uint8, mode="r")
    engines, out = [], {}
    for engine in staging.ENGINES:
        if engine == "io_uring" and not staging.io_uring_available():
            out[engine] = f"unavailable: {staging.io_uring_error()}"
            say(f"  read engine io_uring {out[engine]}")
        else:
            engines.append(engine)
    rounds: dict = {engine: [] for engine in engines}
    for order in (engines, engines[::-1]):
        for engine in order:
            read_s = 0.0
            for off in range(0, nbytes, FED_CHUNK):
                n = min(FED_CHUNK, nbytes - off)
                t0 = time.monotonic()
                staging.read_into(path, buf[:n], offset=payload + off, engine=engine)
                read_s += time.monotonic() - t0
                if staging.read_path() != engine:
                    fail(f"read engines: asked for {engine}, {staging.read_path()} ran")
                if not _same_bytes(buf[:n], mm[payload + off:payload + off + n]):
                    fail(f"read engines: {engine} read other bytes than the file at {off}")
            rounds[engine].append(nbytes / read_s / 1e9)
    del mm
    for engine in engines:
        out[engine] = sum(rounds[engine]) / len(rounds[engine])
    return {e: out[e] for e in staging.ENGINES}, rounds


def check_stage_after_queued_work(path: str, nbytes: int) -> dict:
    """Stage two chunks of the volume into a block that was freed while
    kernels queued on the current stream still wrote it: the caching
    allocator hands such a block straight back on the same stream, so the
    copies land correctly only if the copy stream waits on that stream.

    Two things synchronise the host with the device and would hide the
    hazard, so both are done once first: a page-locked allocation (a
    first stage of the same bytes fills the host cache, as a stage beside
    a running trainer finds it) and the first launch of a kernel (CUDA
    loads modules lazily: the first ``fill_`` would wait out the queued
    work before the copies are enqueued)."""
    import torch

    from oim_tpu_torch.data import plane

    n = 2 * FED_CHUNK
    payload = os.path.getsize(path) - nbytes
    src = plane.ExtentSource([plane.Extent("file", path, payload, n)])
    want = torch.from_numpy(np.fromfile(path, np.uint8, count=n, offset=payload)).cuda()
    warm = plane.stage_source(src, dtype=torch.uint8, shape=(n,), device="cuda",
                              chunk_bytes=FED_CHUNK)
    del warm
    torch.cuda.synchronize()
    block = torch.empty(n, dtype=torch.uint8, device="cuda")
    ptr = block.data_ptr()
    block.fill_(0xAB)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of queued work on the current stream
    block.fill_(0xAB)                 # then a write to the block...
    del block                         # ...freed while both are still queued
    arr = plane.stage_source(src, dtype=torch.uint8, shape=(n,), device="cuda",
                             chunk_bytes=FED_CHUNK)
    reused = arr.data_ptr() == ptr
    torch.cuda.synchronize()
    equal = torch.equal(arr, want)
    say(f"  stage into a block freed under queued work: block reused {reused}, staged "
        f"bytes equal to the file {equal}")
    if not reused:
        fail("oim-fed: the allocator did not hand the freed block to the stage, so the "
             "queued-work check did not reach its case")
    if not equal:
        fail("oim-fed: a stage into a block freed under queued work lost its bytes to "
             "that work (the copy stream did not wait on the current stream)")
    return {"queued_work_block_reused": reused, "queued_work_bytes_equal": equal}


def train_on_tokens(tokens, what: str, others: dict) -> dict:
    """Phase 5's trainer (llama3-8b width, LAYERS layers, B=BATCH, T=SEQ)
    for STEPS steps on ``volume_token_batches`` of a token tensor on the
    card, with phase 5's checks: every loss finite, the first near
    ln(vocab), K1-K3 at LAYERS x STEPS launches each, all on ``wgmma``.
    ``others`` holds other paths' step_s by name, printed beside and
    returned with the run's own."""
    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.data.feeds import volume_token_batches
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train import TrainConfig, Trainer

    vocab = llama.LLAMA3_8B.vocab
    cfg = TrainConfig(model="llama3-8b", model_overrides={"n_layers": LAYERS},
                      batch_size=BATCH, seq_len=SEQ, warmup_steps=2, total_steps=STEPS,
                      log_every=1)
    trainer = Trainer(cfg, device="cuda")
    trainer.init()
    feed = volume_token_batches(tokens, cfg)
    kernels.reset_launches()
    t0 = time.monotonic()
    trainer.run(steps=STEPS, data=feed)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    steady = hist[1:] if len(hist) > 1 else hist
    step_s = sum(r["step_s"] for r in steady) / len(steady)
    mfu = sum(r["mfu"] for r in steady) / len(steady)
    feed_wait = sum(r["feed_wait_s"] for r in steady) / len(steady)
    say(f"  losses {losses}")
    say(f"  launches {launches}, routes {routes}  (want {LAYERS} x {STEPS} each, all wgmma)")
    say(f"  step_s {step_s:.4f} (steps 2..{STEPS}), MFU {mfu:.4f}; "
        + "; ".join(f"{k} {v:.4f}" for k, v in others.items())
        + f"; feed wait {feed_wait * 1e3:.3f} ms a step (a gather of {BATCH} x {SEQ + 1} "
        f"int32 on the card); wall {wall:.1f} s")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{what}: losses not finite or missing: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0:
        fail(f"{what}: first loss {losses[0]} not near ln(vocab) {math.log(vocab):.3f}")
    for name, _ in KERNELS:
        if launches[name] != LAYERS * STEPS or routes[name]["wgmma"] != LAYERS * STEPS:
            fail(f"{what}: {name} launched {launches[name]} times ({routes[name]}), want "
                 f"{LAYERS * STEPS} on wgmma")
    return {"launches": launches, "routes": routes, "losses": losses, "step_s": step_s,
            "mfu": mfu, "feed_wait_s": feed_wait, **others}


def phase_oim_fed(synthetic_step_s: float) -> dict:
    """Phase 8: a token volume staged from disk through CUDABackend, checked,
    restaged from the cache, cancelled and freed, then fed to the trainer."""
    import gc
    import shutil
    import tempfile

    import torch

    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.data import plane, staging
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.spec import ArraySpec, FileParams

    vocab = llama.LLAMA3_8B.vocab
    nbytes = FED_TOKENS * 4
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated()
    out: dict = {"tokens": FED_TOKENS, "volume_bytes": nbytes, "chunk_bytes": FED_CHUNK,
                 "host_copy": "direct: page-locked reader buffer -> device"}

    def run_stage(backend, volume_id: str, params) -> tuple:
        vol = StagedVolume(volume_id, b"", ArraySpec())
        t0 = time.monotonic()
        backend.stage(vol, "file", params)
        vol.wait()
        return vol, time.monotonic() - t0

    with tempfile.TemporaryDirectory(prefix="oim-fed-") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < nbytes + (1 << 30):
            fail(f"oim-fed: the temp disk at {tmp} has {free / 2**30:.1f} GiB free, the "
                 f"volume needs {nbytes / 2**30:.0f} GiB (+1): cut FED_TOKENS")
        path = os.path.join(tmp, "tokens.npy")
        t0 = time.monotonic()
        write_token_volume(path, FED_TOKENS, vocab)
        out["write_s"] = time.monotonic() - t0
        say(f"  wrote {FED_TOKENS} int32 tokens in [0, {vocab}) ({nbytes / 2**30:.0f} GiB .npy) "
            f"in {out['write_s']:.1f} s; {free / 2**30:.0f} GiB were free")
        out.update(check_stage_after_queued_work(path, nbytes))

        # -- cold stage --
        params = FileParams(path, "npy")
        backend = CUDABackend(cache_bytes=FED_CACHE, chunk_bytes=FED_CHUNK)
        calls = plane.STAGE_CALLS
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.max_memory_allocated()
        vol, stage_s = run_stage(backend, "oim-fed", params)
        if vol.state != StageState.READY:
            fail(f"oim-fed: the cold stage ended {vol.state}: {vol.error}")
        growth = torch.cuda.max_memory_allocated() - before
        out.update(stage_s=stage_s, stage_gbps=nbytes / stage_s / 1e9,
                   breakdown=dict(plane.LAST_STAGE_BREAKDOWN), read_path=staging.read_path(),
                   stage_peak_model_bytes=plane.LAST_STAGE_PEAK, device_growth_bytes=growth,
                   plane_calls=plane.STAGE_CALLS - calls)
        bd = out["breakdown"]
        say(f"  cold stage: {stage_s:.3f} s, {out['stage_gbps']:.2f} GB/s; breakdown disk_s "
            f"{bd['disk_s']:.3f} (a page-cache read: the file was just written; "
            f"{out['read_path']}), h2d_s {bd['h2d_s']:.3f}, dispatch_s {bd['dispatch_s']:.3f}")
        if out["read_path"] != "native":
            fail(f"oim-fed: the cold stage read through {out['read_path']}, not the native "
                 "engine built in phase 2")
        say(f"  device bytes: plane model {out['stage_peak_model_bytes']}, growth of "
            f"max_memory_allocated {growth} (volume {nbytes}, limit volume + 2 chunks)")
        if growth > nbytes + 2 * FED_CHUNK or out["plane_calls"] != 1:
            fail(f"oim-fed: device growth {growth} > volume + 2 chunks, or "
                 f"{out['plane_calls']} plane calls for one stage")
        engines, rounds = time_read_engines(path, os.path.getsize(path) - nbytes, nbytes)
        timed = {k: v for k, v in engines.items() if isinstance(v, float)}
        fastest = max(timed, key=timed.get)
        yard = {"h2d_gbps": h2d_gbps(), "read_gbps": timed[fastest],
                "read_gbps_by_engine": engines, "read_gbps_rounds": rounds,
                "read_engine_fastest": fastest}
        halves = (nbytes / (yard["read_gbps"] * 1e9), nbytes / (yard["h2d_gbps"] * 1e9))
        out.update(yard, bound_s=max(halves), faster_half_s=min(halves),
                   stage_over_bound=stage_s / max(halves))
        say(f"  yardsticks, same run: pinned {FED_CHUNK >> 20} MiB H2D {yard['h2d_gbps']:.2f} "
            f"GB/s (CUDA events); the file read alone into a pinned {FED_CHUNK >> 20} MiB "
            "buffer, by engine, mean of two rounds in turned order (all from a warm page "
            "cache: the file was just written; a cold disk is not measured): " + ", ".join(
                f"{k} {v:.2f} GB/s ({', '.join(f'{r:.2f}' for r in rounds[k])})"
                if isinstance(v, float) else f"{k} {v}"
                for k, v in engines.items()) + f"; fastest {fastest}")
        say(f"  stage bound {out['bound_s']:.3f} s (the slower half, the fastest engine's read "
            f"or H2D, alone; "
            f"the faster half takes {out['faster_half_s']:.3f} s): stage / bound "
            f"{out['stage_over_bound']:.2f}")

        # -- bytes --
        t0 = time.monotonic()
        check_volume_bytes(vol.array, path)
        say(f"  staged tensor equal to the file, byte for byte ({time.monotonic() - t0:.1f} s)")

        # -- cache hit --
        ptr = vol.array.data_ptr()
        backend.unstage(vol)
        calls = plane.STAGE_CALLS
        hit, out["cache_hit_s"] = run_stage(backend, "oim-fed", params)
        same = hit.array is not None and hit.array.data_ptr() == ptr
        say(f"  restage after unstage: {out['cache_hit_s'] * 1e3:.2f} ms, plane calls "
            f"{plane.STAGE_CALLS - calls}, same storage {same}")
        if hit.state != StageState.READY or plane.STAGE_CALLS != calls or not same:
            fail("oim-fed: the restage was not served from the stage cache")
        backend.unstage(hit)

        # -- cancel, then free --
        other = CUDABackend(cache_bytes=FED_CACHE, chunk_bytes=FED_CHUNK, keep_cached=False)
        cvol = StagedVolume("oim-fed-2", b"", ArraySpec())
        other.stage(cvol, "file", params)
        while cvol.state == StageState.STAGING and cvol.bytes_staged < FED_CANCEL_AT:
            time.sleep(0.0005)
        out["cancel_at_bytes"] = cvol.bytes_staged
        other.unstage(cvol)
        cvol.wait()
        if cvol.state != StageState.FAILED or cvol.error != "unmapped during staging":
            fail(f"oim-fed: a stage unstaged at {out['cancel_at_bytes']} bytes ended "
                 f"{cvol.state} {cvol.error!r}")
        freed = backend.cache.evict_idle()
        gc.collect()
        after = torch.cuda.memory_allocated()
        say(f"  unstaged at {out['cancel_at_bytes']} landed bytes: FAILED "
            f"{cvol.error!r}; evicting the cache freed {freed} bytes; memory_allocated "
            f"{after} against {base_alloc} before the phase")
        if after != base_alloc:
            fail(f"oim-fed: {after - base_alloc} device bytes held after unstage, cancel "
                 f"and eviction")

        # -- train on the volume --
        vol, out["restage_s"] = run_stage(backend, "oim-fed", params)
        if vol.state != StageState.READY:
            fail(f"oim-fed: the restage ended {vol.state}: {vol.error}")
    out.update(train_on_tokens(vol.array, "oim-fed", {"synthetic_step_s": synthetic_step_s}))
    backend.unstage(vol)
    backend.cache.evict_idle()
    del vol
    gc.collect()
    torch.cuda.empty_cache()
    return out

# -- OIM-fed ResNet-50 (phase 9) ------------------------------------------

# bench.py's OIM-fed cell (bench.py:333-342, :426-500): 1024 uint8 images
# of 224x224x3 staged as one volume, batch 128 sliced from it in place,
# 1000 classes, bf16. Nothing is cut.
RESNET_IMAGES, RESNET_SIZE, RESNET_BATCH, RESNET_CLASSES = 1024, 224, 128, 1000
RESNET_STEPS, RESNET_CKPT_EVERY = 8, 4
# Resumed and remat losses against the first run's, relative: the same
# bf16 arithmetic, but cuDNN's weight-gradient kernels may sum in another
# order from call to call.
RESNET_REL_TOL = 1e-3
# The remat step's bf16 gradients against the plain step's, the worst
# leaf's relative L2 (one bf16 rounding step is 2^-8 = 3.9e-3 of a value;
# a block whose backward went wrong reads of order 1).
RESNET_GRAD_TOL = 1e-2

RESNET_CATEGORIES = (
    ("convolution (cuDNN)", ("aten::cudnn_convolution", "aten::convolution_backward",
                             "aten::_convolution", "aten::convolution")),
    ("pooling, head and loss", ("aten::max_pool2d_with_indices",
                                "aten::max_pool2d_with_indices_backward", "aten::mean",
                                "aten::mm", "aten::addmm", "aten::logsumexp",
                                "aten::gather", "aten::scatter", "aten::scatter_add")),
)


def clone_state(state):
    """A deep copy of a TrainState on its device, params requiring grad."""
    from oim_tpu_torch.train.state import OptState, TrainState, tree_leaves

    def c(tree):
        if isinstance(tree, dict):
            return {k: c(v) for k, v in tree.items()}
        return tree.detach().clone()

    params = c(state.params)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = state.opt_state
    return TrainState(step=state.step, params=params, extra=c(state.extra),
                      opt_state=OptState(count=opt.count, mu=c(opt.mu), nu=c(opt.nu)))


def state_differences(a, b) -> list[str]:
    """Where two TrainStates differ in any byte (dtype, shape and strides
    included), the steps and the optimizer's count too."""
    import torch

    from oim_tpu_torch.train.state import tree_leaves

    diffs = [n for n, x, y in (("step", a.step, b.step),
                               ("count", a.opt_state.count, b.opt_state.count)) if x != y]
    for name, x, y in (("params", a.params, b.params), ("extra", a.extra, b.extra),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        xs, ys = list(tree_leaves(x)), list(tree_leaves(y))
        if len(xs) != len(ys):
            diffs.append(f"{name}: {len(xs)} leaves against {len(ys)}")
            continue
        for i, (s, t) in enumerate(zip(xs, ys)):
            t = t.to(s.device)
            if (s.dtype, s.shape, s.stride()) != (t.dtype, t.shape, t.stride()) or \
                    not torch.equal(s.detach().contiguous().reshape(-1).view(torch.uint8),
                                    t.detach().contiguous().reshape(-1).view(torch.uint8)):
                diffs.append(f"{name} leaf {i}")
    return diffs


def phase_resnet(llama_main: dict, profile: bool) -> dict:
    """Phase 9: bench.py's OIM-fed ResNet-50 through the port's Trainer:
    stage, train with checkpoints, evaluate, resume, remat; then phase 5's
    llama with remat."""
    import dataclasses
    import gc
    import itertools
    import shutil
    import tempfile

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.data.feeds import SeekableFeed
    from oim_tpu_torch.models import resnet
    from oim_tpu_torch.spec import ArraySpec, FileParams
    from oim_tpu_torch.train import TrainConfig, Trainer
    from oim_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer
    from oim_tpu_torch.train.state import tree_leaves
    from oim_tpu_torch.train.trainer import flops_per_step

    n, size, batch = RESNET_IMAGES, RESNET_SIZE, RESNET_BATCH
    shape = (n, size, size, 3)
    out: dict = {"model": "resnet50", "images": n, "image_size": size, "batch": batch,
                 "classes": RESNET_CLASSES, "dtype": "bfloat16",
                 "params": resnet.num_params(resnet.Config())}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="oim-resnet-") as tmp:
        # -- stage the volume --
        path = os.path.join(tmp, "images.raw")
        host = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
        with open(path, "wb") as f:
            host.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        backend = CUDABackend()
        vol = StagedVolume("resnet-images", b"", ArraySpec(shape, "uint8"))
        t0 = time.monotonic()
        backend.stage(vol, "file", FileParams(path, "raw"))
        vol.wait()
        out["stage_s"] = time.monotonic() - t0
        out["volume_bytes"] = host.nbytes
        if vol.state != StageState.READY:
            fail(f"resnet: the stage ended {vol.state}: {vol.error}")
        images = vol.array
        exact = (tuple(images.shape) == shape and images.dtype == torch.uint8
                 and torch.equal(images, torch.from_numpy(host).to(images.device)))
        say(f"  staged {n} uint8 images [{n},{size},{size},3] ({host.nbytes} bytes) in "
            f"{out['stage_s']:.3f} s ({host.nbytes / out['stage_s'] / 1e9:.2f} GB/s); equal "
            f"to the file byte for byte: {exact}")
        if not exact:
            fail("resnet: the staged images differ from the file")
        del host
        labels = torch.from_numpy(np.random.RandomState(0).randint(0, RESNET_CLASSES, n)).to(
            images.device, torch.int32)

        def batches(start):
            """bench.py's one_step slices of the staged volume, batch start on."""
            for i in itertools.count(start):
                lo = (i * batch) % (n - batch + 1)
                yield {"images": images[lo:lo + batch], "labels": labels[lo:lo + batch]}

        # -- train, checkpointing every RESNET_CKPT_EVERY steps --
        ckpt_dir = os.path.join(tmp, "ckpt")
        cfg = TrainConfig(model="resnet50", batch_size=batch, image_size=size,
                          num_classes=RESNET_CLASSES, warmup_steps=2,
                          total_steps=RESNET_STEPS, log_every=1, checkpoint_dir=ckpt_dir,
                          checkpoint_every=RESNET_CKPT_EVERY)
        trainer = Trainer(cfg, device="cuda")
        trainer.init()
        init_extra = [t.clone() for t in tree_leaves(trainer.state.extra)]
        feed = SeekableFeed(batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.monotonic()
        trainer.run(steps=RESNET_CKPT_EVERY, data=feed)
        saved = clone_state(trainer.state)  # what the step-4 checkpoint holds
        trainer.run(steps=RESNET_STEPS, data=feed)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hist = trainer.history
        losses = [r["loss"] for r in hist]
        steady = hist[1:]
        step_s = sum(r["step_s"] for r in steady) / len(steady)
        mfu = sum(r["mfu"] for r in steady) / len(steady)
        extra = list(tree_leaves(trainer.state.extra))
        moved = sum(not torch.equal(a, b) for a, b in zip(init_extra, extra))
        finite = all(bool(t.isfinite().all()) for t in extra)
        say(f"  losses {[round(x, 4) for x in losses]}  (ln {RESNET_CLASSES} = "
            f"{math.log(RESNET_CLASSES):.3f})")
        say(f"  BN running statistics: {moved} of {len(extra)} leaves moved from their init, "
            f"all finite {finite}; K1-K3 launches {launches} (want 0)")
        say(f"  step_s {step_s:.4f} (steps 2..{RESNET_STEPS}; step 1 {hist[0]['step_s']:.4f})  "
            f"images/s {batch / step_s:.1f}  MFU {mfu:.4f} of 989e12 "
            f"({flops_per_step(cfg) / 1e12:.3f} TFLOP a step: 3 x 4.1e9 x {batch})  "
            f"peak mem {peak_gb:.2f} GB  wall {wall:.1f} s")
        if len(losses) != RESNET_STEPS or not all(math.isfinite(x) for x in losses):
            fail(f"resnet: losses not finite or missing: {losses}")
        if abs(losses[0] - math.log(RESNET_CLASSES)) > 1.0:
            fail(f"resnet: first loss {losses[0]} not within 1.0 of ln {RESNET_CLASSES}")
        if not finite or moved != len(extra):
            fail(f"resnet: BN statistics not finite ({finite}) or {len(extra) - moved} "
                 f"leaves never moved")
        if any(launches.values()):
            fail(f"resnet: the ResNet path launched attention kernels: {launches}")
        out.update(losses=losses, step_s=step_s, images_per_s=batch / step_s, mfu=mfu,
                   step1_s=hist[0]["step_s"], flops_per_step=flops_per_step(cfg),
                   peak_mem_gb=peak_gb, train_wall_s=wall, launches=launches)

        # -- eval --
        before = [t.clone() for t in tree_leaves(trainer.state.extra)]
        eval_loss = trainer.evaluate(batches(RESNET_STEPS), 2)
        acc = trainer.last_eval_stats["accuracy"]
        untouched = all(torch.equal(a, b) for a, b in
                        zip(before, tree_leaves(trainer.state.extra)))
        say(f"  eval, 2 batches in inference mode: loss {eval_loss:.4f}, accuracy {acc:.4f}; "
            f"BN state byte-identical after: {untouched}")
        if not (math.isfinite(eval_loss) and 0.0 <= acc <= 1.0 and untouched):
            fail(f"resnet: eval loss {eval_loss}, accuracy {acc}, state untouched {untouched}")
        out["eval"] = {"loss": eval_loss, "accuracy": acc}

        # -- resume from step 4 --
        # As if the run had been cut after its step-4 checkpoint, during
        # the save of step 8: no step-8 directory, a partial temporary one.
        shutil.rmtree(os.path.join(ckpt_dir, str(RESNET_STEPS)))
        os.makedirs(os.path.join(ckpt_dir, f".tmp-{RESNET_STEPS}-0"))
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, str(RESNET_CKPT_EVERY), STATE_FILE))
        resumed = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        start = resumed.init_or_resume()
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        diffs = state_differences(saved, resumed.state)
        say(f"  resume: init_or_resume() -> {start} in {restore_s:.3f} s from a "
            f"{ckpt_bytes / 1e6:.1f} MB checkpoint; restored state differs from the saved "
            f"one in {len(diffs)} places {diffs[:5]}")
        if start != RESNET_CKPT_EVERY or diffs:
            fail(f"resnet: resumed at {start} (want {RESNET_CKPT_EVERY}), or the restored "
                 f"state differs: {diffs[:10]}")
        del saved
        feed = SeekableFeed(batches)
        feed.seek(start)
        resumed.run(steps=RESNET_STEPS, data=feed)
        rlosses = [r["loss"] for r in resumed.history]
        rel = [abs(a - b) / abs(b) for a, b in zip(rlosses, losses[start:])]
        say(f"  resumed steps {start + 1}..{RESNET_STEPS}: losses "
            f"{[round(x, 4) for x in rlosses]}, largest relative difference from the first "
            f"run {max(rel):.2e} (limit {RESNET_REL_TOL})")
        if len(rlosses) != RESNET_STEPS - start or not max(rel) <= RESNET_REL_TOL:
            fail(f"resnet: resumed losses {rlosses} against {losses[start:]}")
        timing = Checkpointer(os.path.join(tmp, "timing"))
        t0 = time.monotonic()
        timing.save(RESNET_STEPS, resumed.state, wait=True)
        save_s = time.monotonic() - t0
        say(f"  checkpoint: {ckpt_bytes} bytes; save {save_s:.3f} s (snapshot to the host "
            f"and write, fsync and rename), restore {restore_s:.3f} s")
        out["checkpoint"] = {"bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
                             "resumed_at": start, "resumed_losses": rlosses,
                             "max_rel_diff": max(rel)}

        # -- remat: one step from a copy of the same state, the same batch --
        # Plain twice (the card's run-to-run spread), then remat. The loss
        # is the forward's, which remat leaves alone; the gradients that
        # reach the optimizer, their norm and the params after the update
        # are what the recomputation could get wrong.
        base = resumed.state
        del trainer
        one_batch = next(batches(RESNET_STEPS))
        steps = {}
        for name, remat in (("plain", False), ("plain again", False), ("remat", True)):
            t = Trainer(dataclasses.replace(cfg, remat=remat, checkpoint_dir=""), device="cuda")
            t.state = clone_state(base)
            seen = []
            update = t.tx.update

            def keep_grads(grads, *rest, update=update, seen=seen):
                seen.extend(tree_leaves(grads))
                return update(grads, *rest)

            t.tx.update = keep_grads
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t.state, stats = t.step_fn(t.state, one_batch)
            loss = float(stats["loss"])
            torch.cuda.synchronize()
            steps[name] = {"loss": loss, "grad_norm": float(stats["grad_norm"]),
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "above_state_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                           "grads": [g.float().cpu() for g in seen],
                           "params": [p.detach().float().cpu()
                                      for p in tree_leaves(t.state.params)]}
            del t, stats, seen
        plain, again, rm = steps["plain"], steps["plain again"], steps["remat"]

        def rel(a, b):
            return abs(a - b) / abs(b)

        def worst_leaf(key, run):
            return max(float((x - y).norm() / y.norm()) for x, y in zip(run[key], plain[key]))

        readings = {run: {"loss": rel(steps[run]["loss"], plain["loss"]),
                          "grad_norm": rel(steps[run]["grad_norm"], plain["grad_norm"]),
                          "grads": worst_leaf("grads", steps[run]),
                          "params": worst_leaf("params", steps[run])}
                    for run in ("plain again", "remat")}
        say(f"  remat: one step from one state and batch: loss {rm['loss']:.6f} against "
            f"{plain['loss']:.6f} without, grad_norm {rm['grad_norm']:.6f} against "
            f"{plain['grad_norm']:.6f}; relative differences from the plain step (grads and "
            f"params: the worst leaf, L2): remat {readings['remat']}, plain again "
            f"{readings['plain again']}; peak memory {rm['peak_mem_gb']:.2f} GB against "
            f"{plain['peak_mem_gb']:.2f} ({rm['above_state_gb']:.2f} against "
            f"{plain['above_state_gb']:.2f} GB above the state)")
        limits = {"loss": RESNET_REL_TOL, "grad_norm": RESNET_REL_TOL,
                  "grads": RESNET_GRAD_TOL, "params": RESNET_REL_TOL}
        over = {k: v for k, v in readings["remat"].items() if not v <= limits[k]}
        if len(rm["grads"]) != len(plain["grads"]) or not rm["grads"] or over:
            fail(f"resnet: the remat step differs from the plain one: {over} "
                 f"(limits {limits}; {len(rm['grads'])} gradient leaves against "
                 f"{len(plain['grads'])})")
        out["remat"] = {"loss": rm["loss"], "plain_loss": plain["loss"],
                        "grad_norm": rm["grad_norm"], "plain_grad_norm": plain["grad_norm"],
                        "rel_diff": readings["remat"], "plain_again_rel_diff":
                        readings["plain again"], "peak_mem_gb": rm["peak_mem_gb"],
                        "plain_peak_mem_gb": plain["peak_mem_gb"],
                        "above_state_gb": rm["above_state_gb"],
                        "plain_above_state_gb": plain["above_state_gb"]}
        del steps, plain, again, rm
        if profile:
            out["profile"] = profile_resnet_step(resumed, one_batch)
        del resumed, base, feed, images, labels, one_batch
        backend.unstage(vol)
        del vol
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 5's llama with remat --
    argv = main_path_argv() + ["--remat"]
    say(f"  python -m oim_tpu_torch.cli.oim_trainer {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer = oim_trainer.run(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llosses = [r["loss"] for r in trainer.history]
    rel = [abs(a - b) / abs(b) for a, b in zip(llosses, llama_main["losses"])]
    want = {"flash_fwd": 2 * LAYERS * STEPS, "flash_bwd_dkv": LAYERS * STEPS,
            "flash_bwd_dq": LAYERS * STEPS}
    say(f"  losses {llosses}; largest relative difference from phase 5's {max(rel):.2e}")
    say(f"  launches {launches} (want {want}: the forward runs again in the backward), "
        f"routes {routes}")
    say(f"  peak memory {peak_gb:.2f} GB against phase 5's {llama_main['peak_mem_gb']:.2f} GB")
    if len(llosses) != STEPS or not max(rel) <= RESNET_REL_TOL:
        fail(f"llama remat: losses {llosses} against phase 5's {llama_main['losses']}")
    for name, count in want.items():
        if launches[name] != count or routes[name]["wgmma"] != count:
            fail(f"llama remat: {name} launched {launches[name]} times ({routes[name]}), "
                 f"want {count} on wgmma")
    out["llama_remat"] = {"losses": llosses, "max_rel_diff": max(rel), "launches": launches,
                          "routes": routes, "peak_mem_gb": peak_gb,
                          "plain_peak_mem_gb": llama_main["peak_mem_gb"]}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_resnet_step(trainer, batch) -> dict:
    """One more ResNet step under torch.profiler: device ms by category
    (convolutions, batch norm and elementwise, the optimizer, the rest),
    the top kernels and the idle share; written to
    chiprun_out/chip_smoke_resnet_profile.json."""
    prof, wall_ms = profiled_train_step(trainer, batch)
    kernels_ = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
                for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
                and not ev.key.startswith("optimizer")]
    busy = sum(k[1] for k in kernels_)
    cats = device_ms_by_category(prof, (OPTIMIZER_RANGE,), RESNET_CATEGORIES,
                                 "batch norm, ReLU and elementwise")
    attributed = sum(cats.values())
    if busy > attributed + 1e-3:
        cats["not attributed to an op"] = busy - attributed
    idle = max(0.0, 1 - busy / wall_ms)
    launches = sum(k[2] for k in kernels_)
    say(f"  profiled ResNet step: wall {wall_ms:.1f} ms (the profiler's host work included), "
        f"device busy {busy:.1f} ms, idle share {idle:.3f}; {launches} kernel launches")
    for cat, ms in sorted(cats.items(), key=lambda c: -c[1]):
        say(f"    {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}  {cat}")
    for key, ms, count in sorted(kernels_, key=lambda k: -k[1])[:12]:
        say(f"    {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    result = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": idle,
              "kernel_launches": launches, "categories": cats, "kernels": kernels_}
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke_resnet_profile.json").write_text(json.dumps(result, indent=1))
    return result


# -- Mixture-of-Experts (phases 10-13) -------------------------------------

# The MoE flagship (scripts/sweep_moe.py:37-42, scripts/capacity_quality.py:
# 66-73): llama3-8b's fields at vocab 32768, dim 2048, 8 layers, 16/8 heads
# of 128, mlp 8192, 4 experts, top-2, gather dispatch, capacity factor 1.25;
# the full vocab's logits (no vocab chunks), B=BATCH, T=SEQ. Nothing is cut.
MOE_OVERRIDES = ("vocab=32768", "dim=2048", "n_layers=8", "n_heads=16", "mlp_dim=8192",
                 "n_experts=4", "vocab_chunk=0")
MOE_STEPS = 4
# Its layers, parameters and active parameters (the JAX package's counts).
MOE_FLAGSHIP_COUNTS = (8, 1_845_594_112, 1_040_287_744)
MOE_TINY_TOL = 1e-4  # f32, card against CPU, TF32 off (phase 4's)
# Gather against einsum dispatch, one bf16 step from one state: the
# einsum combine rounds once where gather rounds per routing round, and a
# route whose top-2/3rd gap falls under the bf16 difference flips in a
# later layer. Loss and grad_norm, sums over every token, have read up to
# 1.28e-4 and 3.35e-4 relative on the H100: the limit is ~3x the larger.
# The worst gradient leaf, which flipped routes move, has read 0.135-0.155
# (relative L2): its limit, ~3x, catches a combine with no gradient (1.0).
MOE_DISPATCH_REL = 1e-3
MOE_DISPATCH_GRAD_REL = 0.5
MOE_SERVE_TAILS, MOE_SERVE_NEW = (40, 7), 32


def moe_flagship():
    """The flagship's llama.Config: llama3-8b with MOE_OVERRIDES."""
    import dataclasses

    from oim_tpu_torch.models import llama

    return dataclasses.replace(llama.LLAMA3_8B, **{
        k: int(v) for k, v in (item.split("=") for item in MOE_OVERRIDES)})


def moe_argv() -> list[str]:
    argv = ["--model", "llama3-8b"]
    for item in MOE_OVERRIDES:
        argv += ["--override", item]
    return argv + ["--steps", str(MOE_STEPS), "--batch-size", str(BATCH), "--seq-len",
                   str(SEQ), "--warmup-steps", "2", "--log-every", "1", "--log-level", "info"]


def phase_moe_agreement() -> dict:
    """Phase 10: llama.tiny with 4 experts (f32) on the card against the
    CPU: the loss, drop fraction and gradients; moe.apply in both dispatch
    modes with drops and at k=1; greedy generate(); the paged steps."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import llama, moe
    from oim_tpu_torch.train.state import tree_leaves

    errors: list[str] = []
    cfg = llama.tiny(n_experts=4)
    host = llama.to_numpy(llama.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, 130), generator=torch.Generator().manual_seed(1))
    res, calls = {}, []
    with patched(moe, "apply", moe_calls(calls)):
        for dev in ("cpu", "cuda"):
            p = llama.from_numpy(host, dev)
            leaves = list(tree_leaves(p))
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, stats = llama.loss_and_stats(p, tokens.to(dev), cfg)
            grads = torch.autograd.grad(loss, leaves)
            res[dev] = (loss.detach().cpu(), stats["moe_drop_frac"].detach().cpu(),
                        [g.detach().cpu() for g in grads])
    tiny_margin = min(float(moe.router_margin(p["router"], x, c.top_k)) for p, x, c in calls)
    say(f"  llama.tiny, 4 experts, f32 (T=129): loss cpu {float(res['cpu'][0]):.6f} cuda "
        f"{float(res['cuda'][0]):.6f}; moe_drop_frac cpu {float(res['cpu'][1]):.6f} cuda "
        f"{float(res['cuda'][1]):.6f}; smallest top-k router margin {tiny_margin:.3e}")
    check("loss", res["cuda"][0], res["cpu"][0], MOE_TINY_TOL, errors)
    check("moe_drop_frac (a count)", res["cuda"][1], res["cpu"][1], 0.0, errors)
    grad_err = max(max_err(a, b) for a, b in zip(res["cuda"][2], res["cpu"][2]))
    say(f"  gradients ({len(res['cpu'][2])} leaves) max_abs_err {grad_err:.3e}  "
        f"tol {MOE_TINY_TOL:.3e}")
    if not grad_err <= MOE_TINY_TOL:
        errors.append(f"gradients: max_abs_err {grad_err}")
    margins = {"llama.tiny": tiny_margin}

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 64, 64, generator=g)
    for e, k, cf in ((4, 2, 0.5), (4, 1, 1.0)):
        for dispatch in ("gather", "einsum"):
            mcfg = moe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf, dispatch=dispatch)
            mp = moe.init(torch.Generator().manual_seed(3), 64, 192, mcfg, torch.float32,
                          device="cpu")
            outs = {}
            for dev in ("cpu", "cuda"):
                leaves = [t.to(dev).requires_grad_(True) for t in mp.values()]
                xd = x.to(dev).requires_grad_(True)
                out, st = moe.apply(dict(zip(mp, leaves)), xd, mcfg, with_stats=True)
                gs = torch.autograd.grad((out * out).sum() + st[0], leaves + [xd])
                outs[dev] = [out.detach().cpu(), st.detach().cpu()] + [t.cpu() for t in gs]
            name = f"moe.apply k={k} cf={cf} {dispatch}"
            margins[name] = float(moe.router_margin(mp["router"], x, k))
            say(f"  {name}: dropped {float(outs['cpu'][1][1]):.4f} (cpu) "
                f"{float(outs['cuda'][1][1]):.4f} (cuda), router margin {margins[name]:.3e}")
            check("  out", outs["cuda"][0], outs["cpu"][0], MOE_TINY_TOL, errors)
            check("  [aux, dropped]", outs["cuda"][1], outs["cpu"][1], MOE_TINY_TOL, errors)
            err = max(max_err(a, b) for a, b in zip(outs["cuda"][2:], outs["cpu"][2:]))
            say(f"    gradients (router, experts, x) max_abs_err {err:.3e}")
            if not err <= MOE_TINY_TOL:
                errors.append(f"{name} gradients: max_abs_err {err}")

    prompt = torch.randint(0, cfg.vocab, (2, 5), generator=g)
    toks = {dev: gen.generate(llama.from_numpy(host, dev), prompt.to(dev), 12, cfg).cpu()
            for dev in ("cpu", "cuda")}
    same = torch.equal(toks["cpu"], toks["cuda"])
    say(f"  greedy generate(), 2 rows x 12 tokens: card equal to CPU: {same}")
    if not same:
        errors.append(f"generate: {toks['cuda'].tolist()} against {toks['cpu'].tolist()}")
    check_paged_steps(cfg, host, "cuda", errors)
    if errors:
        fail("MoE on the card disagrees with the CPU: " + "; ".join(errors))
    return {"router_margins": margins, "loss": float(res["cuda"][0]),
            "moe_drop_frac": float(res["cuda"][1]), "grad_max_abs_err": grad_err}


def leaf_rels(xs, ys) -> list[float]:
    """The relative L2 difference of each pair of two lists of tensors."""
    return [float((x.detach().float() - y.detach().float()).norm() / y.detach().float().norm())
            for x, y in zip(xs, ys)]


def worst_leaf_rel(xs, ys) -> float:
    return max(leaf_rels(xs, ys))


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Key paths of a nested dict's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def moe_dispatch_by_layer(params, tokens, mcfg) -> list[dict]:
    """Gather against einsum dispatch, layer by layer, from one state and
    batch (no gradient): the share of tokens whose top-k expert set
    differs between the two models' forwards, and each dispatch on the
    gather forward's own FFN input, where the router sees one input and no
    route can flip (max|diff| / max|out|, and whether [aux, dropped] are
    equal)."""
    import dataclasses

    import torch

    from oim_tpu_torch.models import llama, moe

    fwd = {}
    with torch.no_grad():
        for c in (mcfg, dataclasses.replace(mcfg, moe_dispatch="einsum")):
            fwd[c.moe_dispatch] = []
            with patched(moe, "apply", moe_calls(fwd[c.moe_dispatch])):
                llama.loss_and_stats(params, tokens, c)

    def experts(p, x, c):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"].float(), -1)
        return probs.topk(c.top_k, dim=-1).indices.sort(dim=-1).values

    rows = []
    with torch.no_grad():
        for (p, x, c), (_, xe, ce) in zip(fwd["gather"], fwd["einsum"]):
            flipped = (experts(p, x, c) != experts(p, xe, ce)).any(dim=-1)
            out_g, st_g = moe.apply(p, x, c, with_stats=True)
            out_e, st_e = moe.apply(p, x, ce, with_stats=True)
            rows.append({"routes_flipped": float(flipped.float().mean()),
                         "same_input": bool(torch.equal(x, xe)),
                         "out_rel": float((out_e.float() - out_g.float()).abs().max()
                                          / out_g.float().abs().max()),
                         "stats_equal": bool(torch.equal(st_g, st_e))})
    return rows


def phase_moe_main(profile: bool) -> dict:
    """Phase 11: the MoE flagship trained through the CLI, then one step
    from one state and batch with einsum dispatch and one with remat."""
    import dataclasses
    import gc

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train import Trainer
    from oim_tpu_torch.train.state import tree_leaves
    from oim_tpu_torch.train.trainer import flops_per_step, synthetic_batches

    argv = moe_argv()
    say(f"  python -m oim_tpu_torch.cli.oim_trainer {' '.join(argv)}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.monotonic()
    trainer = oim_trainer.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, hist = trainer.cfg, trainer.history
    mcfg = cfg.model_config()
    losses = [r["loss"] for r in hist]
    drops = [r.get("moe_drop_frac") for r in hist]
    want = mcfg.n_layers * MOE_STEPS
    n_total, n_active = llama.num_params(mcfg), llama.num_active_params(mcfg)
    say(f"  {mcfg.n_layers} layers, dim {mcfg.dim}, {mcfg.n_experts} experts top-"
        f"{mcfg.moe_top_k}, {mcfg.moe_dispatch} dispatch, cf {mcfg.moe_capacity_factor}: "
        f"{n_total:,} parameters, {n_active:,} active; {flops_per_step(cfg) / 1e12:.2f} "
        f"TFLOP a step (active)")
    say(f"  losses {losses}  (ln {mcfg.vocab} = {math.log(mcfg.vocab):.3f})")
    say(f"  moe_drop_frac {drops}")
    say(f"  launches {launches}  (want {mcfg.n_layers} x {MOE_STEPS} = {want} each)")
    say(f"  routes {routes}  (want every launch on wgmma)")
    if (mcfg.n_layers, n_total, n_active) != MOE_FLAGSHIP_COUNTS:
        fail(f"MoE main path: the config is not the flagship's {MOE_FLAGSHIP_COUNTS}: {mcfg}")
    if len(losses) != MOE_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"MoE main path: losses not finite or missing: {losses}")
    if abs(losses[0] - math.log(mcfg.vocab)) > 1.0:
        fail(f"MoE main path: first loss {losses[0]} not within 1.0 of ln {mcfg.vocab}")
    if not all(d is not None and 0.0 <= d < 1.0 for d in drops):
        fail(f"MoE main path: moe_drop_frac missing or outside [0, 1): {drops}")
    for name, _ in KERNELS:
        if launches[name] != want or routes[name]["wgmma"] != want:
            fail(f"MoE main path: {name} launched {launches[name]} times ({routes[name]}), "
                 f"want {want} on wgmma")
    steady = hist[1:]
    step_s = sum(r["step_s"] for r in steady) / len(steady)
    mfu = sum(r["mfu"] for r in steady) / len(steady)
    tokens = BATCH * SEQ
    say(f"  step_s {step_s:.4f} (steps 2..{MOE_STEPS}; step 1 {hist[0]['step_s']:.4f})  "
        f"tokens/s {tokens / step_s:.0f}  MFU {mfu:.4f} of 989e12 on active FLOPs  "
        f"peak mem {peak_gb:.1f} GB  wall {wall:.1f} s")
    out = {"config": dict(item.split("=") for item in MOE_OVERRIDES), "batch": BATCH,
           "seq": SEQ, "params": n_total, "active_params": n_active,
           "flops_per_step": flops_per_step(cfg), "losses": losses, "moe_drop_frac": drops,
           "launches": launches, "routes": routes, "step_s": step_s,
           "step1_s": hist[0]["step_s"], "tokens_per_s": tokens / step_s, "mfu": mfu,
           "peak_mem_gb": peak_gb}

    if profile:
        out["profile"] = profile_step(trainer, "chip_smoke_moe_profile.json")
    # One step from one state and batch: plain twice (the card's spread),
    # einsum dispatch, remat under dots_with_no_batch_dims.
    base = trainer.state
    del trainer
    gc.collect()
    batch = {"tokens": torch.as_tensor(next(synthetic_batches(
        dataclasses.replace(cfg, seed=cfg.seed + 1)))["tokens"]).cuda()}
    runs = (("plain", {}, False, ""), ("plain again", {}, False, ""),
            ("einsum", {"moe_dispatch": "einsum"}, False, ""),
            ("remat", {}, True, "dots_with_no_batch_dims"))
    ref, readings, names, grads_by_layer = None, {}, leaf_names(base.params), []
    by_layer = moe_dispatch_by_layer(base.params, batch["tokens"], mcfg)
    for name, over, remat, policy in runs:
        t = Trainer(dataclasses.replace(cfg, remat=remat, remat_policy=policy,
                                        checkpoint_dir="",
                                        model_overrides={**cfg.model_overrides, **over}),
                    device="cuda")
        t.state = clone_state(base)
        seen = []
        update = t.tx.update

        def keep_grads(grads, *rest, update=update, seen=seen):
            seen.extend(tree_leaves(grads))
            return update(grads, *rest)

        t.tx.update = keep_grads
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        t.state, stats = t.step_fn(t.state, batch)
        loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        run = {"loss": loss, "grad_norm": gnorm, "step_wall_s": time.monotonic() - t0,
               "moe_drop_frac": float(stats["moe_drop_frac"]), "peak_mem_gb": peak / 1e9,
               "above_held_gb": (peak - held) / 1e9}
        params = list(tree_leaves(t.state.params))
        if ref is None:
            ref = dict(run, grads=seen, params=[p.detach() for p in params])
        else:
            rels = leaf_rels(seen, ref["grads"])
            run.update(loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                       grad_norm_rel=abs(gnorm - ref["grad_norm"]) / abs(ref["grad_norm"]),
                       grads=max(rels), params=worst_leaf_rel(params, ref["params"]),
                       worst_grad_leaf=names[rels.index(max(rels))])
            if name == "einsum":
                run["grads_by_leaf"] = dict(zip(names, rels))
                grads_by_layer = [max(float((g[i].float() - r[i].float()).norm()
                                            / r[i].float().norm())
                                      for n, g, r in zip(names, seen, ref["grads"])
                                      if n.startswith("/layers/"))
                                  for i in range(mcfg.n_layers)]
        readings[name] = {k: v for k, v in run.items() if not isinstance(v, list)}
        del t, stats, seen, params
    del ref, base
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in readings.items():
        rel = ("" if name == "plain" else
               f"; against plain: loss {r['loss_rel']:.2e}, grad_norm {r['grad_norm_rel']:.2e}, "
               f"grads {r['grads']:.2e}, params {r['params']:.2e} (relative; worst leaf, L2)")
        say(f"  one step, {name:<11s}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f} "
            f"drop {r['moe_drop_frac']:.4f}, {r['step_wall_s']:.4f} s, peak {r['peak_mem_gb']:.1f} "
            f"GB ({r['above_held_gb']:.1f} above what was held before the step){rel}"
            f"{'' if name == 'plain' else '; worst gradient leaf ' + r['worst_grad_leaf']}")
    say("  the einsum step's gradient against plain, by leaf (relative L2): " + ", ".join(
        f"{n} {r:.2e}" for n, r in readings["einsum"]["grads_by_leaf"].items()))
    for i, (row, g) in enumerate(zip(by_layer, grads_by_layer)):
        row["einsum_step_grads"] = g
        say(f"  layer {i}: top-{mcfg.moe_top_k} routes flipped (einsum forward against "
            f"gather) {row['routes_flipped']:.4%}; the dispatch alone, gather's FFN input "
            f"through both: out {row['out_rel']:.2e} of max|out| (limit {BF16_REL_TOL:.4f}), "
            f"[aux, dropped] equal {row['stats_equal']}; the einsum step's gradient, worst "
            f"leaf of the layer, {g:.3e} relative L2")
    bad = [i for i, row in enumerate(by_layer)
           if not (row["out_rel"] <= BF16_REL_TOL and row["stats_equal"])]
    if bad or not by_layer[0]["same_input"] or by_layer[0]["routes_flipped"] != 0:
        fail(f"MoE: einsum dispatch differs from gather on one input (layers {bad}), or the "
             f"first layer's input or routes differ between the two forwards: {by_layer}")
    ein, rm = readings["einsum"], readings["remat"]
    if not (ein["loss_rel"] <= MOE_DISPATCH_REL and ein["grad_norm_rel"] <= MOE_DISPATCH_REL
            and ein["grads"] <= MOE_DISPATCH_GRAD_REL):
        fail(f"MoE: einsum dispatch differs from gather beyond {MOE_DISPATCH_REL} (loss, "
             f"grad_norm) or {MOE_DISPATCH_GRAD_REL} (worst gradient leaf): {ein}")
    limits = {"loss_rel": RESNET_REL_TOL, "grad_norm_rel": RESNET_REL_TOL,
              "grads": RESNET_GRAD_TOL, "params": RESNET_REL_TOL}
    over = {k: rm[k] for k, v in limits.items() if not rm[k] <= v}
    if over:
        fail(f"MoE: the remat step differs from the plain one: {over} (limits {limits})")
    out["one_step"] = readings
    out["dispatch_by_layer"] = by_layer
    return out


def phase_moe_serve(profile: bool) -> dict:
    """Phase 12: ServeEngine on the MoE flagship, full depth, bf16."""
    import gc

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.models import llama, moe
    from oim_tpu_torch.serve import ServeEngine
    from oim_tpu_torch.train.state import tree_leaves

    cfg = moe_flagship()
    t0 = time.monotonic()
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    say(f"  llama.init on the card: {llama.num_params(cfg):,} params, "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f} GB, "
        f"{time.monotonic() - t0:.1f} s")
    rs = np.random.RandomState(1)
    reqs = [{"name": f"len{n}", "prompt": rs.randint(0, cfg.vocab, n).tolist(),
             "max_new": MOE_SERVE_NEW, "temperature": 0.0, "seed": i}
            for i, n in enumerate(SERVE_LENGTHS)]
    prefix = rs.randint(0, cfg.vocab, SERVE_PREFIX).tolist()
    reqs += [{"name": f"prefix+{t}", "prompt": prefix + rs.randint(0, cfg.vocab, t).tolist(),
              "max_new": MOE_SERVE_NEW, "temperature": 0.0, "seed": 20 + j, "shared": True}
             for j, t in enumerate(MOE_SERVE_TAILS)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    eng = ServeEngine(params, cfg, device="cuda", **SERVE_ENGINE)
    t0 = time.monotonic()
    as_tuple = [(r["prompt"], r["max_new"], 0.0, r["seed"]) for r in reqs]
    # The second shared-prefix request goes in after the first retired and
    # donated its prompt's blocks to the store.
    outs = run_requests(eng, as_tuple[:-1]) + run_requests(eng, as_tuple[-1:])
    wall = time.monotonic() - t0
    stats = eng.stats()
    for r, o in zip(reqs, outs):
        r["out"] = o
    eng.stop(drain=True)
    eng.evict_prefix_store()
    eng.evict_host_tier()
    used = eng.pool_stats()["used_pages"]
    say(f"  {len(reqs)} greedy requests of {[len(r['prompt']) for r in reqs]} tokens, "
        f"{MOE_SERVE_NEW} new each: all ended by length; prefix hits {stats['prefix_hits']} "
        f"({stats['prefill_tokens_cached']} tokens from the store); {stats['decode_tokens']} "
        f"decode tokens in {stats['target_steps']} steps; wall {wall:.2f} s; pages used "
        f"after drain and eviction {used}")
    if stats["prefix_hits"] < 1:
        fail(f"MoE serving: the shared-prefix request missed the prefix store: {stats}")
    if used:
        fail(f"MoE serving: {used} pages leaked past drain and eviction")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    calls = []
    result = serve_measure(cfg, params, reqs, "cuda", profile, calls,
                           "chip_smoke_moe_serve_profile.json")
    margin = min(float(moe.router_margin(p["router"], x, c.top_k, set_only=True))
                 for p, x, c in calls)
    say(f"  the 8-row first decode step's smallest top-2 router margin (2nd against 3rd "
        f"expert) over its {len(calls)} layers: {margin:.3e}; "
        f"the decode bound reads all {cfg.n_experts} experts' weights (no-drop routing "
        f"runs every expert on every token's slot)")
    result.update(wall_s=wall, prefix_hits=stats["prefix_hits"],
                  prefill_tokens_cached=stats["prefill_tokens_cached"],
                  decode_tokens=stats["decode_tokens"], target_steps=stats["target_steps"],
                  first_decode_min_router_margin=margin,
                  kernel_launches=dict(kernels.LAUNCHES),
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_oim_infer() -> dict:
    """Phase 13: the trainer CLI writes a llama-tiny-moe checkpoint on the
    card; oim-infer restores it and decodes."""
    import contextlib
    import io
    import tempfile

    import torch

    from oim_tpu_torch.cli import oim_infer, oim_trainer
    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.train.checkpoint import Checkpointer

    prompt = [[1, 2, 3, 4], [50, 60, 70, 80]]
    with tempfile.TemporaryDirectory(prefix="oim-infer-") as tmp:
        ck = os.path.join(tmp, "ck")
        trainer = oim_trainer.run(["--model", "llama-tiny-moe", "--steps", "3", "--batch-size",
                                   "4", "--seq-len", "64", "--checkpoint-dir", ck,
                                   "--log-level", "warning"])
        mcfg = trainer.cfg.model_config()
        argv = ["--checkpoint-dir", ck, "--model", "llama-tiny-moe", "--prompt",
                ";".join(",".join(map(str, row)) for row in prompt), "--n-new", "16",
                "--log-level", "warning"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = oim_infer.main(argv)
        rows = [[int(t) for t in line.split(",")] for line in buf.getvalue().split()]
        params = Checkpointer(ck).restore(device="cuda").params
        want = gen.generate(params, torch.tensor(prompt, device="cuda"), 16, mcfg).tolist()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                empty_rc = oim_infer.main(["--checkpoint-dir", os.path.join(tmp, "empty"),
                                           "--model", "llama-tiny-moe", "--log-level",
                                           "warning"])
        except SystemExit as e:  # a message exits with status 1
            empty_rc = 1 if isinstance(e.code, str) else e.code
    say(f"  python -m oim_tpu_torch.cli.oim_infer {' '.join(argv)} -> exit {rc}")
    for row in rows:
        say(f"    {','.join(map(str, row))}")
    say(f"  rows equal to generate() on the restored params: {rows == want}; with no "
        f"checkpoint: exit {empty_rc!r}")
    if rc != 0 or rows != want:
        fail(f"oim-infer: exit {rc}, rows {rows} against generate() {want}")
    if empty_rc in (0, None):
        fail("oim-infer: a directory without a checkpoint did not exit nonzero")
    return {"rows": rows, "equal_to_generate": True, "no_checkpoint_exit": empty_rc}


# -- sources (phase 14) ----------------------------------------------------

# One-card cuts of real deployments, each volume >= 1 GiB (phase_sources).
SRC_TF_SHARDS = 8                       # ImageNet's train split: 1,024 shards
SRC_TF_SHARD_BYTES = 128 << 20          # of about this size each
SRC_TF_IMAGE_BYTES = (96_000, 124_000)  # ~110 KB a JPEG (seeded bytes, not decoded)
SRC_WDS_SHARDS = 4
SRC_WDS_SHARD_BYTES = 256 << 20
SRC_CEPH_BYTES = 1 << 30
SRC_CACHE = 8 << 30                     # stage-cache capacity: every volume fits
SRC_BLOCK = 256 << 20                   # bytes generated and written at a time


class _GatewayHandler(http.server.BaseHTTPRequestHandler):
    """An object gateway: the URL path names a file under the server's
    root; HEAD, ranged GET (``sendfile``), an ETag from the file's mtime
    and size (as nginx makes it: a rewrite moves it), and HTTP Basic auth
    where an object asks for it."""

    def log_message(self, *args):
        pass

    def _object(self):
        gw = self.server
        need = gw.auth.get(self.path)
        if need and self.headers.get("Authorization") != need:
            self.send_error(401, "unauthorized")
            return None
        path = os.path.join(gw.root, self.path.lstrip("/"))
        try:
            st = os.stat(path)
        except OSError:
            self.send_error(404, "no such object")
            return None
        return path, st.st_size, f'"{st.st_mtime_ns:x}-{st.st_size:x}"'

    def _headers(self, code: int, length: int, etag: str, extra=()) -> None:
        self.send_response(code)
        self.send_header("Content-Length", str(length))
        self.send_header("ETag", etag)
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()

    def do_HEAD(self):
        obj = self._object()
        if obj is not None:
            self._headers(200, obj[1], obj[2])

    def do_GET(self):
        obj = self._object()
        if obj is None:
            return
        path, size, etag = obj
        start, end, code, extra = 0, size - 1, 200, ()
        rng = self.headers.get("Range", "")
        if rng.startswith("bytes="):
            lo, _, hi = rng[len("bytes="):].partition("-")
            start, end = int(lo), min(int(hi) if hi else size - 1, size - 1)
            code, extra = 206, (("Content-Range", f"bytes {start}-{end}/{size}"),)
        self._headers(code, end - start + 1, etag, extra)
        with open(path, "rb") as f:
            self.connection.sendfile(f, start, end - start + 1)


def _serve_gateway(root: str, auth: dict, port_pipe) -> None:
    """The gateway process: serves ``root`` on a free loopback port, sends
    the port back, and runs until it is terminated."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _GatewayHandler)
    server.daemon_threads = True
    server.root, server.auth = root, auth
    port_pipe.send(server.server_port)
    port_pipe.close()
    server.serve_forever()


def basic_auth(user: str, secret: str) -> str:
    return "Basic " + base64.b64encode(f"{user}:{secret}".encode()).decode()


@contextlib.contextmanager
def object_gateway(root: str, auth: dict):
    """The gateway in a process of its own (as a real gateway is: it does
    not share the stager's interpreter lock); yields its base URL and
    stops the process on the way out."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_serve_gateway, args=(root, auth, send), daemon=True,
                       name="oim-gateway")
    proc.start()
    try:
        if not recv.poll(60):
            fail("sources: the object gateway did not start")
        yield f"http://127.0.0.1:{recv.recv()}"
    finally:
        proc.terminate()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join(30)


def fsync_file(path: str) -> None:
    with open(path, "rb+") as f:
        os.fsync(f.fileno())


def write_tfrecord_shards(tmp: str, seed: int = 8) -> tuple[list[str], list[int]]:
    """SRC_TF_SHARDS TFRecord files of framed tf.Examples in the ImageNet
    convention: ``image/encoded`` (seeded bytes of SRC_TF_IMAGE_BYTES),
    ``image/class/label`` in 1..1000, height, width and format. Returns
    the paths and every record's label, in order."""
    from oim_tpu_torch.data import readers

    rng = np.random.default_rng(seed)
    paths, labels = [], []
    for i in range(SRC_TF_SHARDS):
        blob = rng.integers(0, 256, SRC_TF_SHARD_BYTES + SRC_TF_IMAGE_BYTES[1],
                            dtype=np.uint8).tobytes()
        records, pos = [], 0
        while pos < SRC_TF_SHARD_BYTES:
            n = int(rng.integers(*SRC_TF_IMAGE_BYTES))
            label = int(rng.integers(1, 1001))
            records.append(readers.encode_example({
                "image/encoded": blob[pos:pos + n], "image/class/label": label,
                "image/height": int(rng.integers(200, 800)),
                "image/width": int(rng.integers(200, 800)), "image/format": b"JPEG"}))
            labels.append(label)
            pos += n
        path = os.path.join(tmp, f"train-{i:05d}-of-01024")
        readers.write_tfrecords(path, records)
        fsync_file(path)
        paths.append(path)
    return paths, labels


def write_token_shards(tmp: str, vocab: int, seed: int = 9) -> tuple[list[str], np.ndarray]:
    """SRC_WDS_SHARDS webdataset tars of ``.bin`` members, each SEQ + 1
    seeded int32 tokens in [0, vocab) (one training record), written with
    ``tarfile``. Returns the paths and every token, in order."""
    rng = np.random.default_rng(seed)
    member = 512 + -(-(SEQ + 1) * 4 // 512) * 512  # header + padded payload
    per_shard = -(-SRC_WDS_SHARD_BYTES // member)
    paths, tokens = [], []
    for i in range(SRC_WDS_SHARDS):
        toks = rng.integers(0, vocab, (per_shard, SEQ + 1), dtype=np.int32)
        path = os.path.join(tmp, f"pretrain-{i:06d}.tar")
        with tarfile.open(path, "w") as tf:
            for j, row in enumerate(toks):
                info = tarfile.TarInfo(f"{i:06d}/{j:08d}.bin")
                info.size = row.nbytes
                tf.addfile(info, io.BytesIO(row.tobytes()))
        fsync_file(path)
        paths.append(path)
        tokens.append(toks.reshape(-1))
    return paths, np.concatenate(tokens)


def write_object(path: str, nbytes: int, seed: int = 10) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for a in range(0, nbytes, SRC_BLOCK):
            rng.integers(0, 256, min(SRC_BLOCK, nbytes - a), dtype=np.uint8).tofile(f)
        f.flush()
        os.fsync(f.fileno())


def check_against_files(arr, paths: list[str], what: str) -> None:
    """The staged uint8 tensor against the files laid back to back."""
    import torch

    pos = 0
    for path in paths:
        size = os.path.getsize(path)
        for a in range(0, size, SRC_BLOCK):
            n = min(SRC_BLOCK, size - a)
            want = torch.from_numpy(np.fromfile(path, np.uint8, count=n, offset=a)).to(arr.device)
            got = arr[pos + a:pos + a + n]
            if got.numel() != n or not torch.equal(got, want):
                fail(f"sources: {what} differs from {os.path.basename(path)} in bytes "
                     f"[{a}, {a + n}) (volume offset {pos + a})")
        pos += size
    if pos != arr.numel():
        fail(f"sources: {what} holds {arr.numel()} bytes, the files {pos}")


def source_read_gbps(src) -> float:
    """The volume read alone through the plane's readers (the engine for
    files, ranged GETs for objects) into a pinned FED_CHUNK buffer, chunk
    by chunk as a stage reads it (host clock)."""
    import torch

    from oim_tpu_torch.data import plane

    buf = torch.empty(FED_CHUNK, dtype=torch.uint8, pin_memory=True).numpy()
    t0 = time.monotonic()
    for off in range(0, src.total_bytes, FED_CHUNK):
        plane.read_range(src, off, buf[:min(FED_CHUNK, src.total_bytes - off)])
    return src.total_bytes / (time.monotonic() - t0) / 1e9


def phase_sources(others: dict) -> dict:
    """Phase 14: the data plane's other sources staged through
    ``CUDABackend()`` (its default cuda device) and checked on the card.

    Cuts, each volume a one-card slice of a real deployment:
    - TFRecord: SRC_TF_SHARDS of ImageNet's 1,024 train shards (~128 MiB
      of framed tf.Examples each, ~110 KB seeded image bytes a record,
      not decoded): 1 GiB.
    - webdataset by URL (configuration 5's path): SRC_WDS_SHARDS tars of
      ~256 MiB of ``.bin`` members, SEQ + 1 seeded int32 tokens each, in
      llama3-8b's vocab: 1 GiB, ~477 M tokens of a pretraining corpus.
    - ceph: one SRC_CEPH_BYTES object behind the gateway, Basic auth.
    The object gateway is a ThreadingHTTPServer on 127.0.0.1, in a process
    of its own, serving the files: its rate is the host's loopback, not a
    network's."""
    import gc
    import shutil
    import tempfile

    import torch

    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.data import objectstore, plane, readers, staging
    from oim_tpu_torch.data.feeds import _wds_tokens
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.spec import ArraySpec, CephParams, TFRecordParams, WebDatasetParams

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    h2d = h2d_gbps()
    out: dict = {"h2d_gbps": h2d, "chunk_bytes": FED_CHUNK,
                 "gateway": "ThreadingHTTPServer on 127.0.0.1 in its own process: loopback, "
                            "the host's rate, not a network's"}
    backend = CUDABackend(cache_bytes=SRC_CACHE, chunk_bytes=FED_CHUNK)

    def stage(kind: str, params, name: str):
        vol = StagedVolume(name, b"", ArraySpec())
        calls = plane.STAGE_CALLS
        t0 = time.monotonic()
        backend.stage(vol, kind, params)
        vol.wait()
        return vol, time.monotonic() - t0, plane.STAGE_CALLS - calls

    def cold(kind: str, params, name: str, source: str) -> tuple:
        """A first stage: READY through one plane call, its time, rate and
        breakdown against the bound from this run's halves."""
        vol, stage_s, calls = stage(kind, params, name)
        if vol.state != StageState.READY or calls != 1:
            fail(f"sources: {name} ended {vol.state} after {calls} plane calls: {vol.error}")
        bd = dict(plane.LAST_STAGE_BREAKDOWN)
        read_path = staging.read_path()
        nbytes = vol.array.numel()
        read = source_read_gbps(plane.lower_source(kind, params))
        halves = (nbytes / (read * 1e9), nbytes / (h2d * 1e9))
        rec = {"volume_bytes": nbytes, "stage_s": stage_s, "stage_gbps": nbytes / stage_s / 1e9,
               "breakdown": bd, "read_gbps": read, "bound_s": max(halves),
               "bound_by": "read" if halves[0] >= halves[1] else "h2d",
               "stage_over_bound": stage_s / max(halves)}
        say(f"  {name}: {nbytes / 2**30:.2f} GiB staged in {stage_s:.3f} s, "
            f"{rec['stage_gbps']:.2f} GB/s; breakdown {source}_s {bd['disk_s']:.3f}, h2d_s "
            f"{bd['h2d_s']:.3f}, dispatch_s {bd['dispatch_s']:.3f}; the source read alone "
            f"{read:.2f} GB/s, pinned H2D {h2d:.2f} GB/s: bound {rec['bound_s']:.3f} s "
            f"({rec['bound_by']}), stage / bound {rec['stage_over_bound']:.2f}")
        return vol, rec, read_path

    def restage_hits(vol, kind: str, params, name: str) -> float:
        ptr = vol.array.data_ptr()
        backend.unstage(vol)
        hit, hit_s, calls = stage(kind, params, name)
        same = hit.array is not None and hit.array.data_ptr() == ptr
        say(f"  {name} restaged unchanged: {hit_s * 1e3:.2f} ms, plane calls {calls}, "
            f"same storage {same}")
        if hit.state != StageState.READY or calls or not same:
            fail(f"sources: the unchanged restage of {name} was not a cache hit")
        backend.unstage(hit)
        return hit_s

    vocab = llama.LLAMA3_8B.vocab
    secret = "oim-gateway-secret"
    with tempfile.TemporaryDirectory(prefix="oim-sources-") as tmp, object_gateway(
            tmp, {"/rbd/oim-image-0": basic_auth("oim", secret)}) as gw:
        need = SRC_TF_SHARDS * SRC_TF_SHARD_BYTES + SRC_WDS_SHARDS * SRC_WDS_SHARD_BYTES \
            + SRC_CEPH_BYTES + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            fail(f"sources: the temp disk at {tmp} has {free / 2**30:.1f} GiB free, the "
                 f"volumes need {need / 2**30:.1f} GiB: cut the SRC_ sizes")

        # -- TFRecord --
        t0 = time.monotonic()
        tf_paths, labels = write_tfrecord_shards(tmp)
        say(f"  wrote {SRC_TF_SHARDS} TFRecord shards, {len(labels)} tf.Examples, in "
            f"{time.monotonic() - t0:.1f} s")
        params = TFRecordParams(tuple(tf_paths))
        vol, rec, read_path = cold("tfrecord", params, "tfrecord", "disk")
        if read_path != "native":
            fail(f"sources: the TFRecord stage read through {read_path}, not the native engine")
        rec["read_path"] = read_path
        check_against_files(vol.array, tf_paths, "the TFRecord volume")
        t0 = time.monotonic()
        host = vol.array.cpu().numpy()
        got = [int(readers.parse_example(r)["image/class/label"][0])
               for r in readers.iter_tfrecord_bytes(host)]
        del host
        say(f"  TFRecord volume equal to its files; copied back and walked: {len(got)} "
            f"records, labels equal to those written {got == labels} "
            f"({time.monotonic() - t0:.1f} s)")
        if got != labels:
            fail(f"sources: {len(got)} TFRecord labels read back, {len(labels)} written, "
                 "or a label differs")
        rec.update(shards=SRC_TF_SHARDS, records=len(labels),
                   cache_hit_s=restage_hits(vol, "tfrecord", params, "tfrecord"))
        out["tfrecord"] = rec
        backend.cache.evict_idle()
        for path in tf_paths:
            os.unlink(path)

        # -- webdataset by URL --
        t0 = time.monotonic()
        wds_paths, written = write_token_shards(tmp, vocab)
        urls = [f"{gw}/{os.path.basename(p)}" for p in wds_paths]
        say(f"  wrote {SRC_WDS_SHARDS} webdataset shards, {written.size // (SEQ + 1)} "
            f"samples of {SEQ + 1} tokens, in {time.monotonic() - t0:.1f} s; served at {gw}")
        params = WebDatasetParams(tuple(urls))
        vol, rec, _ = cold("webdataset", params, "webdataset-url", "network")
        check_against_files(vol.array, wds_paths, "the webdataset volume")
        t0 = time.monotonic()
        host = vol.array.cpu().numpy()
        tokens = _wds_tokens(host)
        equal = tokens.shape == written.shape and bool(np.array_equal(tokens, written))
        del host
        say(f"  webdataset volume equal to its shards; _wds_tokens recovered {tokens.size} "
            f"tokens, equal to those written {equal} ({time.monotonic() - t0:.1f} s)")
        if not equal:
            fail("sources: the tokens recovered from the webdataset volume differ from "
                 "those written")
        train_tokens = torch.from_numpy(tokens.copy()).cuda()
        del tokens, written
        rec["cache_hit_s"] = restage_hits(vol, "webdataset", params, "webdataset-url")
        etag = objectstore.object_validators(urls[-1])[0]
        with open(wds_paths[-1], "r+b") as f:  # one token of the last shard, same size
            f.seek(512)
            old = np.frombuffer(f.read(4), np.int32)[0]
            f.seek(512)
            f.write(np.int32((old + 1) % vocab).tobytes())
        if objectstore.object_validators(urls[-1])[0] == etag:
            fail("sources: the gateway's ETag did not move with the shard's bytes")
        misses = backend.cache.stats()["misses"]
        changed, changed_s, calls = stage("webdataset", params, "webdataset-url")
        missed = backend.cache.stats()["misses"] - misses
        say(f"  one shard's bytes and ETag changed: restage {changed_s:.3f} s, plane calls "
            f"{calls}, cache misses {missed}")
        if changed.state != StageState.READY or calls != 1 or missed != 1:
            fail(f"sources: a changed shard restaged {changed.state} with {calls} plane "
                 f"calls and {missed} misses, want READY, 1 and 1")
        check_against_files(changed.array, wds_paths, "the changed webdataset volume")
        rec.update(shards=SRC_WDS_SHARDS, samples=train_tokens.numel() // (SEQ + 1),
                   changed_restage_s=changed_s)
        out["webdataset_url"] = rec
        backend.unstage(changed)
        del changed, vol
        backend.cache.evict_idle()
        for path in wds_paths:
            os.unlink(path)

        # -- ceph through the gateway --
        os.mkdir(os.path.join(tmp, "rbd"))
        obj = os.path.join(tmp, "rbd", "oim-image-0")
        write_object(obj, SRC_CEPH_BYTES)
        params = CephParams(monitors=gw, user="oim", secret=secret, pool="rbd",
                            image="oim-image-0")
        vol, rec, _ = cold("ceph", params, "ceph", "network")
        check_against_files(vol.array, [obj], "the ceph volume")
        say("  ceph volume equal to its object")
        backend.unstage(vol)
        del vol
        backend.cache.evict_idle()
        gc.collect()
        base = torch.cuda.memory_allocated()
        wrong, _, _ = stage("ceph", CephParams(monitors=gw, user="oim", secret="wrong",
                                               pool="rbd", image="oim-image-0"), "ceph-wrong")
        gc.collect()
        after = torch.cuda.memory_allocated()
        say(f"  a wrong secret: {wrong.state}, {wrong.error!r}; memory_allocated {after} "
            f"against {base} before")
        if wrong.state != StageState.FAILED or "401" not in wrong.error or after != base:
            fail(f"sources: a wrong ceph secret ended {wrong.state} {wrong.error!r} with "
                 f"{after - base} device bytes held")
        rec["wrong_secret_error"] = wrong.error
        out["ceph"] = rec

    say("  training: phase 5's config on the webdataset volume's tokens")
    out["train"] = train_on_tokens(train_tokens, "sources", others)
    out["train"]["tokens"] = train_tokens.numel()
    del train_tokens
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.monotonic() - t_phase
    say(f"  phase wall {out['wall_s']:.1f} s (writing and walking the volumes included)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more llama training step, one decode step "
                         "and one ResNet step (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card only", 2)
    sys.path.insert(0, str(ROOT))
    try:
        import oim_tpu_torch
    except ImportError as e:
        fail(f"the port is not beside this script ({e}): run it from a checkout", 3)
    if Path(oim_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported oim_tpu_torch from {oim_tpu_torch.__file__}, not from {ROOT}", 3)
    from oim_tpu_torch import kernels
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train.state import tree_leaves

    t_start = time.monotonic()
    say("== 1. card")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"  {card}")
    say(f"  torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}  "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    say("== 2. build (nvcc -Xptxas -v: registers and spills per kernel; g++: the read engine)")
    t0 = time.monotonic()
    built = kernels.build(verbose=True)
    say(f"  built {built} in {time.monotonic() - t0:.1f} s")
    native = build_read_engine()

    say("== 3. kernels against their plain versions")
    cfg, moe_cfg = llama.LLAMA3_8B, moe_flagship()
    shapes = {  # the attention of each training path phases 5-11 drive
        "llama3-8b (phases 5, 8, 9)": (BATCH, SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "MoE flagship (phase 11)": (BATCH, SEQ, moe_cfg.n_heads, moe_cfg.n_kv_heads,
                                    moe_cfg.head_dim),
    }
    odd = [
        # b, tq, tk, h, hkv, d, causal, dtype, seed[, lse cotangent in delta]
        (2, 100, 150, 8, 2, 64, False, torch.bfloat16, 2),   # group 4, full, tq < tk
        (1, 77, 130, 4, 4, 128, True, torch.bfloat16, 3),    # group 1, causal, tq < tk
        (1, 130, 70, 4, 1, 40, True, torch.float32, 4),      # tq > tk: fully masked rows
        (1, 200, 120, 4, 4, 128, True, torch.bfloat16, 5),   # the same on the wgmma route, d 128
        (2, 200, 200, 8, 2, 128, True, torch.bfloat16, 6),   # group 4, ragged edges
        (1, 192, 192, 8, 2, 128, True, torch.bfloat16, 7, True),  # delta - g_lse
        (1, 150, 150, 8, 4, 64, True, torch.bfloat16, 9),    # wgmma at d 64, causal, ragged
        (1, 96, 96, 4, 2, 96, True, torch.bfloat16, 8),      # bf16, fma route (d 96)
    ]
    records = phase_kernels(shapes, odd)

    say("== 4. llama.tiny: card against CPU")
    phase_agreement()

    say("== 5. main path")
    main = phase_main_path(args.profile)
    for rec in records:
        rec["launches"] = main["launches"][rec["name"]]
        rec["routes"] = main["routes"][rec["name"]]

    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the trainer's weights and moments

    say("== 6. serving: llama.tiny on the card against the CPU and against itself")
    phase_serve_agreement()

    say("== 7. serving main path: ServeEngine on llama3-8b, 32 layers, bf16")
    t0 = time.monotonic()
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    say(f"  llama.init on the card: {llama.num_params(cfg) / 1e9:.3f}e9 params, "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f} GB, "
        f"{time.monotonic() - t0:.1f} s")
    serve = phase_serve_main(cfg, params, "cuda", args.profile)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    say("== 8. OIM-fed training: a volume staged through CUDABackend feeds the trainer")
    fed = phase_oim_fed(main["step_s"])
    for rec in records:
        rec["oim_fed_launches"] = fed["launches"][rec["name"]]

    say("== 9. OIM-fed ResNet-50: bench.py's cell through the trainer")
    res = phase_resnet(main, args.profile)
    for rec in records:
        rec["resnet_launches"] = res["launches"][rec["name"]]
        rec["llama_remat_launches"] = res["llama_remat"]["launches"][rec["name"]]

    say("== 10. MoE: llama.tiny with 4 experts on the card against the CPU")
    moe_tiny = phase_moe_agreement()

    say("== 11. MoE main path: the MoE flagship trained through the CLI, 8 layers, bf16")
    moe_main = phase_moe_main(args.profile)
    for rec in records:
        rec["moe_launches"] = moe_main["launches"][rec["name"]]
        rec["moe_routes"] = moe_main["routes"][rec["name"]]

    say("== 12. MoE serving: ServeEngine on the MoE flagship, 8 layers, bf16")
    moe_serve = phase_moe_serve(args.profile)

    say("== 13. oim-infer: a llama-tiny-moe checkpoint restored and decoded on the card")
    infer = phase_oim_infer()

    say("== 14. sources: TFRecord, webdataset by URL and ceph staged on the card")
    sources = phase_sources({"synthetic_step_s": main["step_s"], "oim_fed_step_s": fed["step_s"]})
    sources["read_engine"] = native
    for rec in records:
        rec["sources_launches"] = sources["train"]["launches"][rec["name"]]

    say("== 15. summary")
    say(f"  total {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"main_path": {k: main[k] for k in (
        "step_s", "tokens_per_s", "mfu", "peak_mem_gb", "losses")}, "card": card}))
    say(json.dumps({"serve": {k: v for k, v in serve.items() if k != "profile"},
                    "card": card}))
    say(json.dumps({"oim_fed": fed, "card": card}))
    say(json.dumps({"resnet": {k: v for k, v in res.items() if k != "profile"},
                    "card": card}))
    say(json.dumps({"moe": {"agreement": moe_tiny,
                            "train": {k: v for k, v in moe_main.items() if k != "profile"},
                            "serve": {k: v for k, v in moe_serve.items() if k != "profile"},
                            "oim_infer": infer}, "card": card}))
    say(json.dumps({"sources": sources, "card": card}))
    say(json.dumps({"kernels": records}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
