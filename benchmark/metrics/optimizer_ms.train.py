"""Device ms a step of the kernels launched under the harness's range
around ``AdamW.update``, over the profiled steps."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "train" or not t:
        return None
    s = t["range_s"].get("optimizer (AdamW.update)", 0.0)
    return s / t["steps"] * 1e3 if s > 0 else None
