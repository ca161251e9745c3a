"""Device ms a step of the kernels launched under the harness's range
around ``moe.apply``, over the profiled steps: the MoE FFN's forward only
(router, dispatch, expert products, combine); its backward's kernels run
outside any range and are not counted here."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "train" or not t:
        return None
    s = t["range_s"].get("MoE FFN forward (moe.apply)", 0.0)
    return s / t["steps"] * 1e3 if s > 0 else None
