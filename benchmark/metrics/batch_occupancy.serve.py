"""Live rows summed over the window's target steps, over steps x
max_batch, in %: the engine's counters (``stats()["target_steps"]``,
``request_stats()["decode_row_steps"]``), read at the window's edges."""


def read(run):
    c = run.get("counters", {})
    steps = c.get("target_steps", 0)
    if run.get("kind") != "serve" or not steps:
        return None
    return 100.0 * c["decode_row_steps"] / (steps * c["max_batch"])
