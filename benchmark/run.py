"""Run one cell of ``BENCHMARK.json`` on the GPUs of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` the ``breakdown`` of the traced part, ``silent`` where
a metric of the cell found nothing to read (a reader that finds nothing
returns None and its metric is left out of ``metrics``; the names are
also printed on standard error), ``compared`` (what the comparison with
the plain reference read: its sample, and with ``--control`` the
control's readings and ``control_ok``, the control held to the cell's
own limits, which has to come out false), and last ``check``: each
number compared, beside its limit (also the last lines of standard
error).
Exits 2, with no result, where the machine has fewer CUDA devices than the cell asks
for, and 3 where the run loaded JAX or the JAX package.

``--control`` and ``--fault`` measure the comparison and are never part
of a benchmark run: the first adds the fp8 control's reading and its
verdict to ``compared``, the second breaks the timed path underneath (a token
altered where it is made; for training also half the batch left out, or
a step that leaves the state unchanged), so that ``check`` reads what the
fault does to each number."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "_bench_cache"


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=("token", "half_batch", "unchanged"), default=None)
    return p.parse_args(argv)


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault=None, control: bool = False) -> dict:
    """Run ``cell`` and return its result line's object (without the chip
    and module checks, which ``main`` makes)."""
    from benchmark.harness import manifest, serve, train, traffic

    conf = manifest.config(manifest.config_file(bench, ROOT, cell["config"]))
    fam = manifest.family(conf["family"])
    d = fam.dims(conf)
    mix = traffic.load(cell["traffic"])
    limits = manifest.limits(cell["name"])
    driver = {"serve": serve.run, "train": train.run}[mix["kind"]]
    res = driver(cell, fam, d, mix, limits, seed, seconds, trace, device, t_start,
                 fault=fault, control=control)
    import torch

    on_gpu = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    metrics, breakdown, silent = {}, None, []
    if trace:
        context = res["context"]
        for m in manifest.metrics_for(bench, cell["name"], "per_layer"):
            value = manifest.reader(m["name"])(context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                silent.append(m["name"])
        traced = context.get("trace")
        if traced is not None:
            dev["busy_s"] = traced["busy_s"]
            dev["window_s"] = traced["window_s"]
            breakdown = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    else:
        for m in manifest.metrics_for(bench, cell["name"], "end_to_end"):
            value = res["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                silent.append(m["name"])
    check = res["check"]
    out = {"correct": bool(check["ok"]) and res["failed"] == 0 and res["attempted"] > 0,
           "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if silent:
        out["silent"] = silent
    limited = {k: v for k, v in check.items() if isinstance(v, dict) and "limit" in v}
    out["compared"] = {k: v for k, v in check.items() if k != "ok" and k not in limited}
    out["check"] = limited
    return out


def check_lines(out: dict) -> list[str]:
    """What the comparison read: the sample and the control's reading
    first, then each number compared beside its limit, last."""
    lines = [f"compared {k} {v!r}" for k, v in out["compared"].items()]
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in out["check"].items()]
    return lines


def main(argv=None) -> int:
    args = _parse(argv)
    from benchmark.harness import guard, manifest

    try:
        bench = manifest.load(ROOT)
        cell = manifest.cell(bench, args.workload)
    except (FileNotFoundError, KeyError) as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 2
    _caches()
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell['name']} needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    if not (ROOT / "oim_tpu_torch").is_dir():
        print(f"benchmark: the program (oim_tpu_torch) is not in {ROOT}", file=sys.stderr)
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                   fault=args.fault, control=args.control)
    bad = guard.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name in out.get("silent", []):
        print(f"benchmark: metric {name} of this cell found nothing to read", file=sys.stderr)
    for line in check_lines(out):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
