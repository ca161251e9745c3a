"""Mean host-clock ms of a target step: the time from one call of the
engine's ``decode_program`` to the next where no prefill runs between
(the device step, its one token fetch and the loop's turn), over the
window's steps outside the profiled part."""


def read(run):
    steps = run.get("step_s") or []
    if run.get("kind") != "serve" or not steps:
        return None
    return sum(steps) / len(steps) * 1e3
