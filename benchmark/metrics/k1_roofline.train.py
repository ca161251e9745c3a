"""K1 (flash forward): its bound at the cell's shapes (q [B, T, H, hd], k/v [B, T,
Hkv, hd], causal, bf16; ``flops.flash_counts``) times its launches, over
the device time of the kernels whose name holds ``flash_fwd`` in the
profiled steps, in %."""

from benchmark.harness import flops


def read(run):
    t = run.get("trace")
    if run.get("kind") != "train" or not t:
        return None
    got = [v for name, v in t["kernels"].items() if "flash_fwd" in name]
    seconds, launches = sum(v[0] for v in got), sum(v[1] for v in got)
    if seconds <= 0:
        return None
    d, mix = run["dims"], run["mix"]
    f, b = flops.flash_counts("k1", mix["batch"], mix["seq"], d.n_heads, d.n_kv_heads,
                              d.head_dim)
    return 100.0 * launches * flops.bound_s(f, b) / seconds
