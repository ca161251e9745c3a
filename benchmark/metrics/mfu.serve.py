"""Model FLOPs of every prompt and output token whose result arrived in
the window (a prompt's causal forward at its first token, an output
token's forward at its context), over the window, over the card's
989e12 bf16 FLOP/s, in %."""

from benchmark.harness import flops


def read(run):
    if run.get("kind") != "serve" or not run.get("window_flops"):
        return None
    return 100.0 * run["window_flops"] / run["window_s"] / flops.PEAK_FLOPS
