"""Model FLOPs of the window's steps (3 x the causal forward of B x T
tokens: the products with the active weights, top-k experts and the
router, and attention over the kept causal pairs; the family's
``train_flops``, which the training driver gives as ``step_flops``) over
the window, over the card's 989e12 bf16 FLOP/s, in %."""

from benchmark.harness import flops


def read(run):
    if run.get("kind") != "train" or not run.get("steps"):
        return None
    return 100.0 * run["step_flops"] * run["steps"] / run["window_s"] / flops.PEAK_FLOPS
