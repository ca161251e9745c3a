"""The benchmark's own counts of operations and bytes, and the card's
published peaks.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense bf16 989e12
FLOP/s and 3.35e12 B/s of HBM (at its 700 W power limit). A roofline
share is the least time the card could take, max(operations / peak
FLOP/s, bytes / peak B/s), over the measured time. Bytes count each input
read once and each output written once; attention counts the kept causal
pairs (q at position i sees keys 0..i), the work these inputs need."""

from __future__ import annotations

from benchmark.harness.model import Dims

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(t: int) -> int:
    return t * (t + 1) // 2


def matmul_params(d: Dims) -> int:
    """Weights a token multiplies through (top-k experts, the router, the
    head; not the embedding, which is a lookup)."""
    D = d.dim
    attn = D * d.q_dim + 2 * D * d.kv_dim + d.q_dim * D
    if d.n_experts:
        ffn = 3 * d.top_k * D * d.mlp_dim + D * d.n_experts
    else:
        ffn = 3 * D * d.mlp_dim
    return d.n_layers * (attn + ffn) + D * d.vocab


def forward_flops(d: Dims, context: int) -> float:
    """One token's forward FLOPs at a context of ``context`` keys (its
    position + 1): the products with the weights and the attention's QK
    and PV over the context."""
    return 2.0 * matmul_params(d) + 4.0 * d.n_layers * d.q_dim * context


def prompt_flops(d: Dims, n: int) -> float:
    """The forward FLOPs of a whole prompt of ``n`` tokens, causal."""
    return 2.0 * matmul_params(d) * n + 4.0 * d.n_layers * d.q_dim * causal_pairs(n)


def train_flops(d: Dims, batch: int, seq: int) -> float:
    """One training step's model FLOPs: 3 x the forward (forward and
    backward) over ``batch`` rows of ``seq`` tokens, causal."""
    return 3.0 * batch * prompt_flops(d, seq)


def weight_bytes(d: Dims, rows: int) -> int:
    """Bytes of the weights a decode step over ``rows`` rows must read:
    every weight but the embedding (an MoE model's every expert), and the
    embedding's ``rows`` rows."""
    D = d.dim
    attn = D * d.q_dim + 2 * D * d.kv_dim + d.q_dim * D
    experts = max(d.n_experts, 1)
    ffn = 3 * experts * D * d.mlp_dim
    router = D * d.n_experts * F32 if d.n_experts else 0
    norms = (2 * d.n_layers + 1) * D * F32
    return (d.n_layers * ((attn + ffn) * BF16 + router) + D * d.vocab * BF16
            + rows * D * BF16 + norms)


def decode_step_bytes(d: Dims, contexts) -> int:
    """A decode step's bytes bound over live rows at ``contexts`` (each
    row's keys after this step's token): the weights, each row's K/V read
    once, and the new K/V written."""
    contexts = list(contexts)
    kv_token = 2 * d.n_layers * d.kv_dim * BF16
    return (weight_bytes(d, len(contexts)) + kv_token * sum(contexts)
            + kv_token * len(contexts))


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
