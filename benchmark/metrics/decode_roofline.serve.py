"""The decode steps' bytes bound (the weights, each live row's K/V read
once, the new K/V written; the family's ``decode_step_bytes``, summed by
the serving driver into ``decode_bytes``) over 3.35e12 B/s, over the
device time of the kernels launched under the harness's range around
``engine.decode_program``, in the profiled part, in %."""

from benchmark.harness import flops


def read(run):
    t = run.get("trace")
    if run.get("kind") != "serve" or not t or not t.get("decode_steps"):
        return None
    device_s = t["range_s"].get("decode_program", 0.0)
    if device_s <= 0:
        return None
    return 100.0 * (t["decode_bytes"] / flops.PEAK_BYTES) / device_s
