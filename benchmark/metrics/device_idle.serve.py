"""Share of the profiled part of the window in which no kernel, copy or
fill ran on the card, in %."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "serve" or not t or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])
