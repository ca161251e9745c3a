"""The port's ops (oim_tpu_torch.ops) held against the JAX package's, on
the CPU: the same numpy inputs through both, fp32, at test_ops.py's
tolerances (forward 2e-5, gradients 2e-4 unless stated).

The flash kernels' plain versions (what a CPU tensor runs) are held
against the JAX Pallas kernels run in interpret mode, forward and VJP,
including the lse cotangent of flash_attention_lse. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jattn = importlib.import_module("oim_tpu.ops.attention")
from oim_tpu.ops import losses as jlosses
from oim_tpu.ops import norms as jnorms
from oim_tpu.ops import rope as jrope

tattn = importlib.import_module("oim_tpu_torch.ops.attention")
from oim_tpu_torch.ops import losses as tlosses  # noqa: E402
from oim_tpu_torch.ops import norms as tnorms  # noqa: E402
from oim_tpu_torch.ops import rope as trope  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = 2e-5
GRAD_TOL = 2e-4


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


def _qkv(b=2, tq=64, tk=None, h=4, hkv=None, d=32, seed=0):
    rng = np.random.RandomState(seed)
    tk, hkv = tk or tq, hkv or h
    return (rng.randn(b, tq, h, d).astype(np.float32),
            rng.randn(b, tk, hkv, d).astype(np.float32),
            rng.randn(b, tk, hkv, d).astype(np.float32))


def _t(*arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


def test_rmsnorm_matches_jax():
    rng = np.random.RandomState(0)
    x, w = rng.randn(3, 5, 64).astype(np.float32), rng.randn(64).astype(np.float32)
    _close(tnorms.rmsnorm(*_t(x, w)), jnorms.rmsnorm(x, w), FWD_TOL)


def test_rope_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 3, 16).astype(np.float32)
    jc, js = jrope.rope_frequencies(16, 32, 500000.0)
    tc, ts = trope.rope_frequencies(16, 32, 500000.0, device="cpu")
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    _close(trope.apply_rope(torch.tensor(x), tc, ts), jrope.apply_rope(x, jc, js), FWD_TOL)
    pos = rng.randint(0, 32, (2, 12))
    _close(trope.apply_rope(torch.tensor(x), tc, ts, torch.tensor(pos)),
           jrope.apply_rope(x, jc, js, jnp.asarray(pos)), FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_references_match_jax(causal, hkv):
    q, k, v = _qkv(tq=48, tk=80, hkv=hkv)
    _close(tattn.mha_reference(*_t(q, k, v), causal=causal),
           jattn.mha_reference(q, k, v, causal=causal), FWD_TOL)
    to, tl = tattn.ref_attention_lse(*_t(q, k, v), causal=causal)
    jo, jl = jattn.ref_attention_lse(q, k, v, causal=causal)
    _close(to, jo, FWD_TOL)
    _close(tl, jl, FWD_TOL)


def test_causal_mask_is_bottom_right_aligned():
    """Trap 1: with tq < tk the queries are the LAST tq positions.
    scaled_dot_product_attention(is_causal=True) aligns top-left and so
    is not the same function."""
    q, k, v = _qkv(b=1, tq=16, tk=64, h=2, d=16)
    tq, tk, tv = _t(q, k, v)
    ours = tattn.flash_attention(tq, tk, tv, causal=True)
    _close(ours, jattn.mha_reference(q, k, v, causal=True), FWD_TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        is_causal=True).transpose(1, 2)
    assert float((sdpa - ours).abs().max()) > 0.5


def test_fully_masked_rows_match_jax_kernel():
    """Trap 2: rows that see no key (causal, tq > tk) come out 0 with
    lse = -1e30 + log(1e-30), as the TPU kernel's NEG_INF mask, p re-zero
    and l clamp give them."""
    q, k, v = _qkv(b=1, tq=96, tk=64, h=2, d=16, seed=3)
    jo, jl = jattn.flash_attention_lse(q, k, v, True, None, 32, 32, True)
    to, tl = tattn.flash_attention_lse(*_t(q, k, v), causal=True)
    _close(to, jo, FWD_TOL)
    _close(tl, jl, 1e-3, rtol=1e-6)
    assert float(to[0, :32].abs().max()) == 0.0


CASES = [
    # (tq, tk, h, hkv, causal): GQA groups 1/2/4, tq < tk, causal and not
    (64, 64, 4, 4, True),
    (64, 64, 4, 2, False),
    (32, 96, 4, 1, True),
    (32, 96, 4, 4, False),
    (64, 128, 8, 2, True),
]


@pytest.mark.parametrize("tq,tk,h,hkv,causal", CASES)
def test_flash_plain_matches_jax_kernel_forward(tq, tk, h, hkv, causal):
    q, k, v = _qkv(tq=tq, tk=tk, h=h, hkv=hkv)
    jo, jl = jattn._flash_forward(q, k, v, causal, 32 ** -0.5, 32, 32, True)
    to, tl = tattn.flash_forward_plain(*_t(q, k, v), causal, 32 ** -0.5)
    _close(to, jo, FWD_TOL)
    _close(tl, np.asarray(jl)[..., 0], FWD_TOL)


@pytest.mark.parametrize("tq,tk,h,hkv,causal", CASES)
def test_flash_plain_matches_jax_kernel_vjp(tq, tk, h, hkv, causal):
    q, k, v = _qkv(tq=tq, tk=tk, h=h, hkv=hkv, seed=1)
    g = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal, None, 32, 32, True), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq_, tk_, tv_ = _t(q, k, v, grad=True)
    out = tattn.flash_attention(tq_, tk_, tv_, causal=causal)
    tgrads = torch.autograd.grad(out, (tq_, tk_, tv_), torch.tensor(g))
    for a, b in zip(tgrads, jgrads):
        _close(a, b, GRAD_TOL)


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_flash_lse_vjp_including_lse_cotangent(hkv):
    """Trap 4: flash_attention_lse's backward folds the lse cotangent into
    delta; held against the JAX kernel's VJP with both cotangents."""
    q, k, v = _qkv(tq=32, tk=64, hkv=hkv, seed=4)
    rng = np.random.RandomState(5)
    g_out = rng.randn(*q.shape).astype(np.float32)
    g_lse = rng.randn(q.shape[0], q.shape[1], q.shape[2]).astype(np.float32)
    (jo, jl), vjp = jax.vjp(lambda q, k, v: jattn.flash_attention_lse(
        q, k, v, True, None, 32, 32, True), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    tq_, tk_, tv_ = _t(q, k, v, grad=True)
    to, tl = tattn.flash_attention_lse(tq_, tk_, tv_, causal=True)
    _close(to, jo, FWD_TOL)
    _close(tl, jl, FWD_TOL)
    tgrads = torch.autograd.grad((to, tl), (tq_, tk_, tv_),
                                 (torch.tensor(g_out), torch.tensor(g_lse)))
    for a, b in zip(tgrads, jgrads):
        _close(a, b, GRAD_TOL)


def test_plain_forward_rounds_probabilities_to_v_dtype():
    """Trap 3: the forward's probabilities are cast to V's dtype before
    the PV product (bf16 here), while l sums them in f32. Held against the
    JAX kernel in interpret mode on the same bf16 inputs; bf16 outputs
    agree to one bf16 rounding (2^-8 relative)."""
    q, k, v = _qkv(b=1, tq=64, tk=64, h=2, d=32, seed=6)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jo, jl = jattn._flash_forward(*bf, True, 32 ** -0.5, 32, 32, True)
    tb = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in bf]
    to, tl = tattn.flash_forward_plain(*tb, True, 32 ** -0.5)
    _close(to.float(), np.asarray(jo.astype(jnp.float32)), 1e-2)
    _close(tl, np.asarray(jl)[..., 0], 1e-4)
    # Without the rounding the two would differ by more than that rounding.
    exact = tattn.flash_forward_plain(*[t.float() for t in tb], True, 32 ** -0.5)[0]
    assert float((exact - to.float()).abs().max()) > 0


def test_attention_dispatch_on_cpu_runs_plain_version():
    q, k, v = _qkv(tq=32, h=4, hkv=2)
    out, lse = tattn.attention_with_lse(*_t(q, k, v))
    jo, jl = jattn.ref_attention_lse(q, k, v)
    _close(out, jo, FWD_TOL)
    _close(lse, jl, FWD_TOL)
    _close(tattn.attention(*_t(q, k, v)), jattn.mha_reference(q, k, v), FWD_TOL)


def test_attention_refuses_bad_shapes():
    q, k, v = _t(*_qkv(h=4, hkv=3, d=16))
    with pytest.raises(ValueError, match="divisible"):
        tattn.attention(q, k, v)
    q, k, v = _t(*_qkv(h=4, d=16))
    with pytest.raises(ValueError):
        tattn.attention(q, k[..., :8], v[..., :8])


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.RandomState(7)
    logits = rng.randn(4, 6, 50).astype(np.float32) * 3
    labels = rng.randint(0, 50, (4, 6)).astype(np.int32)
    labels[0, :2] = -1
    for ign, z in ((None, 0.0), (-1, 0.0), (-1, 1e-3)):
        lab = labels if ign is not None else np.abs(labels)
        _close(tlosses.softmax_cross_entropy(torch.tensor(logits), torch.tensor(lab), ign, z),
               jlosses.softmax_cross_entropy(logits, lab, ign, z), FWD_TOL)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_chunked_cross_entropy_matches_jax_with_grads(z_loss):
    """Vocab 50 in chunks of 16 (not a multiple), z-loss on and off,
    ignored labels; value, z-term and both gradients."""
    rng = np.random.RandomState(8)
    x = rng.randn(3, 5, 24).astype(np.float32)
    w = (rng.randn(24, 50) * 0.3).astype(np.float32)
    labels = rng.randint(0, 50, (3, 5)).astype(np.int32)
    labels[1, 0] = -1

    def jloss(x, w):
        loss, term = jlosses.chunked_softmax_cross_entropy(
            x, w, labels, 16, -1, z_loss=z_loss, return_z_term=True)
        return loss, term

    (jl, jterm), jvjp = jax.vjp(jloss, x, w)
    jgx, jgw = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    tx, tw = _t(x, w, grad=True)
    tl, tterm = tlosses.chunked_softmax_cross_entropy(
        tx, tw, torch.tensor(labels), 16, -1, z_loss=z_loss, return_z_term=True)
    _close(tl, jl, FWD_TOL)
    _close(tterm, jterm, FWD_TOL)
    tgx, tgw = torch.autograd.grad(tl, (tx, tw))
    _close(tgx, jgx, GRAD_TOL)
    _close(tgw, jgw, GRAD_TOL)


# ------------------------------------------------------------- rules ----

_ROOT = Path(__file__).resolve().parent.parent
_BANNED = ("jax", "jaxlib", "optax", "flax", "orbax", "ml_dtypes", "oim_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((_ROOT / "oim_tpu_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{p.relative_to(_ROOT)}: {mod}" for p in files for mod in _imports(p)
           if mod.split(".")[0] in _BANNED]
    assert not bad, bad
