"""The card's published peaks and the counts that hold for any family:
a kernel's bound, the causal pairs, K1-K3's operations and bytes. A
family module counts its own model's (``benchmark/families/``).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense bf16 989e12
FLOP/s and 3.35e12 B/s of HBM (at its 700 W power limit). A roofline
share is the least time the card could take, max(operations / peak
FLOP/s, bytes / peak B/s), over the measured time. Bytes count each input
read once and each output written once; attention counts the kept causal
pairs (q at position i sees keys 0..i), the work these inputs need."""

from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(t: int) -> int:
    return t * (t + 1) // 2


def flash_counts(kernel: str, b: int, t: int, h: int, hkv: int, hd: int) -> tuple[float, int]:
    """(FLOPs, bytes) of one launch of K1 (forward), K2 (dK/dV) or K3 (dQ)
    at q [b, t, h, hd], k/v [b, t, hkv, hd], bf16, causal; lse and the
    softmax's row sums (delta) in float32."""
    pairs = b * h * causal_pairs(t) * hd
    q = b * t * h * hd * BF16
    kv = b * t * hkv * hd * BF16
    rows = b * h * t * F32
    if kernel == "k1":  # S = QK^T, O = PV; reads q, k, v; writes o, lse
        return 4.0 * pairs, q + 2 * kv + q + rows
    if kernel == "k2":  # S, dP, dV, dK; reads q, k, v, do, lse, delta; writes dk, dv
        return 8.0 * pairs, q + 2 * kv + q + 2 * rows + 2 * kv
    if kernel == "k3":  # S, dP, dQ; reads q, k, v, do, lse, delta; writes dq
        return 6.0 * pairs, q + 2 * kv + q + 2 * rows + q
    raise ValueError(f"unknown kernel {kernel!r}")
