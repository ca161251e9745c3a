"""Chip smoke test of the PyTorch/CUDA port (``oim_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown of
                                       # one step into chiprun_out/

Phases, in order; any failure exits nonzero:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, TF32 off for every float32 product.
2. build: the three flash-attention kernels compiled from
   ``oim_tpu_torch/kernels/csrc`` (one nvcc per source, all at once), with
   ptxas's register and spill lines printed.
3. kernels: each kernel (K1 forward, K2 dK/dV, K3 dQ) held against its
   plain PyTorch version on the same inputs, at the main path's shapes and
   on small odd shapes (non-causal, GQA groups 1 and 4, tq < tk, tq > tk
   with fully masked rows, lengths not a multiple of the tile, a delta that
   carries an lse cotangent, a bf16 head_dim that the kernels serve by the
   fma route); each K1 launch must take the route ``kernels.fwd_route``
   names, each K2/K3 launch the one ``kernels.bwd_route`` names. Its time
   beside its plain version's, its bound, and scaled_dot_product_attention
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
6. the kernels line (JSON), the card line, and the last line
   ``{"ok": true, "device": {...}}``. Beside the contract's keys each
   kernel record has ``routes`` (the main path's launches by kernel route,
   e.g. ``{"wgmma": 8, "fma": 0}``), ``tflops``, ``fma_route_ms`` (the
   CUDA-core kernel on the same inputs) and ``resources`` (registers,
   spills, shared memory and blocks per SM of the route the main path
   took, from the CUDA runtime).

It refuses to run without a CUDA device, and outside a checkout of the
repository (it imports the port from the directory it sits in).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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


def phase_kernels(shape, odd_cases) -> list[dict]:
    """Phase 3: returns one record per kernel at the main path's shape."""
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

    b, t, h, hkv, d = shape
    say(f" main-path shape: q [{b},{t},{h},{d}] k/v [{b},{t},{hkv},{d}] bf16 causal")
    errs, (q, k, v, do, out, lse, delta, scale) = run_case(
        b, t, t, h, hkv, d, True, torch.bfloat16, 1)
    if errors:
        fail("kernels disagree with their plain versions: " + "; ".join(errors))

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


def phase_main_path(profile: bool) -> dict:
    """Phase 5: the CLI's Trainer at llama3-8b width."""
    layers, steps, batch, seq = LAYERS, STEPS, BATCH, SEQ
    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.models import llama

    argv = ["--model", "llama3-8b", "--override", f"n_layers={layers}",
            "--steps", str(steps), "--batch-size", str(batch), "--seq-len", str(seq),
            "--warmup-steps", "2", "--log-every", "1", "--log-level", "info"]
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
    return "elementwise and copies"


def profile_step(trainer) -> dict:
    """One more step under torch.profiler: device time by kernel and by
    category, the idle share of the step's wall time; the table is written
    to chiprun_out/chip_smoke_profile.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from oim_tpu_torch.train.trainer import synthetic_batches

    batch = trainer.place_batch(next(synthetic_batches(trainer.cfg)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        trainer.state, stats = trainer.step_fn(trainer.state, batch)
        float(stats["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # Device-side events only (kernels, memcpy/memset): CPU-side ops carry
    # their children's device time too and would count it twice.
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    cats: dict[str, float] = {}
    for key, ms, _ in rows:
        cats[_category(key)] = cats.get(_category(key), 0.0) + ms
    say(f"  profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for cat, ms in sorted(cats.items(), key=lambda c: -c[1]):
        say(f"    {ms:9.3f} ms  {ms / busy:6.1%}  {cat}")
    for key, ms, count in rows[:12]:
        say(f"    {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    result = {"wall_ms": wall_ms, "busy_ms": busy, "categories": cats, "rows": rows}
    (out / "chip_smoke_profile.json").write_text(json.dumps(result, indent=1))
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path step (torch.profiler)")
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

    say("== 2. build (nvcc -Xptxas -v: registers and spills per kernel)")
    t0 = time.monotonic()
    built = kernels.build(verbose=True)
    say(f"  built {built} in {time.monotonic() - t0:.1f} s")

    say("== 3. kernels against their plain versions")
    cfg = llama.LLAMA3_8B
    shape = (BATCH, SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
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
    records = phase_kernels(shape, odd)

    say("== 4. llama.tiny: card against CPU")
    phase_agreement()

    say("== 5. main path")
    main = phase_main_path(args.profile)
    for rec in records:
        rec["launches"] = main["launches"][rec["name"]]
        rec["routes"] = main["routes"][rec["name"]]

    say("== 6. summary")
    say(f"  total {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"main_path": {k: main[k] for k in (
        "step_s", "tokens_per_s", "mfu", "peak_mem_gb", "losses")}, "card": card}))
    say(json.dumps({"kernels": records}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
