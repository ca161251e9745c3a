"""Run one cell with ``--trace 1`` as ``benchmark.run`` does, and after its
result line print the program's own view of the traced part
(``harness/program.py``) as one more JSON line, ``{"program": ...}``.

    python3 -m benchmark.program_view --workload <cell> --seed <n> --seconds <s>

The view holds the readings of ``program.READINGS`` that the cell's kind
has, the device ms an occurrence of each program range, and beside them
the same quantities under the harness's own ranges. It hooks the harness
from outside (the trace's reduction, the engine's counters at the
window's edges and at the profiler's start and stop); the result line is
the one ``benchmark.run`` prints."""

from __future__ import annotations

import json
import sys


def _hooks(seen: dict):
    """Patches that fill ``seen``: "edges" (the engine's counters each time
    the serving driver reads ``request_stats()``: the window's start and
    end), "profiled" (just before the profiler's start, just before its
    stop and just after), "context" (the driver's context for the
    readers)."""
    import contextlib

    from benchmark.harness import program, serve, train, trace
    from benchmark.harness.trace import patched
    from oim_tpu_torch.serve import engine as eng

    stats, request_stats = eng.ServeEngine.stats, eng.ServeEngine.request_stats
    engines = []

    def snapshot(engine) -> dict:
        return program.engine_counters(stats(engine), request_stats(engine))

    def counted(fn):
        def read(self):
            out = fn(self)
            engines[:] = [self]
            seen["edges"].append(program.engine_counters(stats(self), out))
            return out
        return read

    def note():
        if engines:
            seen["profiled"].append(snapshot(engines[0]))

    def noted(fn):  # the profiler's start: just before it
        def mark(self):
            note()
            fn(self)
        return mark

    def noted_around(fn):  # its stop: just before and just after
        def mark(self):
            note()
            fn(self)
            note()
        return mark

    def viewed(reduce):
        def both(events, ranges):
            out = reduce(events, ranges)
            out["program"] = program.reduce_ranges(events, exclude=ranges)
            harness = [e for e in events if e.get("cat") != "user_annotation"
                       or e.get("name") in ranges]
            out["harness"] = program.reduce_ranges(harness)
            return out
        return both

    def kept(driver):
        def run(*a, **k):
            res = driver(*a, **k)
            res["context"]["program"] = {"window": seen["edges"][:2],
                                         "profiled": seen["profiled"][:3]}
            seen["context"] = res["context"]
            return res
        return run

    stack = contextlib.ExitStack()
    stack.enter_context(patched(eng.ServeEngine, "request_stats", counted))
    stack.enter_context(patched(trace.Profiler, "start", noted))
    stack.enter_context(patched(trace.Profiler, "stop", noted_around))
    stack.enter_context(patched(trace, "reduce_events", viewed))
    stack.enter_context(patched(serve, "run", kept))
    stack.enter_context(patched(train, "run", kept))
    return stack


def view(context: dict) -> dict:
    """The program's readings and ranges, and the harness's ranges, from a
    driver's context."""
    from benchmark.harness import program

    kind = context.get("kind")
    t = context.get("trace") or {}
    out = {"readings": {name: fn(context) for name, fn in program.READINGS.items()
                        if name.endswith("." + kind)}}
    for side in ("program", "harness"):
        ranged = t.get(side) or {}
        out[f"{side}_ms"] = {name: s / ranged["whole"][name] * 1e3
                             for name, s in ranged.get("whole_s", {}).items()
                             if ranged.get("whole", {}).get(name)}
        out[f"{side}_s"] = ranged.get("range_s", {})
        out[f"{side}_count"] = ranged.get("count", {})
    if kind == "train" and t.get("steps"):  # a step holds one moe.forward a layer
        out["per_step_ms"] = {side + ":" + name: s / t["steps"] * 1e3
                              for side in ("program", "harness")
                              for name, s in (t.get(side) or {}).get("range_s", {}).items()}
    out["counters"] = context.get("program")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    from benchmark import run

    seen = {"edges": [], "profiled": [], "context": None}
    run._caches()
    with _hooks(seen):
        code = run.main(argv)
    if code == 0 and seen["context"] is not None:
        print(json.dumps({"program": view(seen["context"])}, default=str), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
