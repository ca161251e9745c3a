"""The flash kernels' arithmetic and routing (K1 forward, K2 dK/dV, K3 dQ),
on the CPU.

The tensor-core route of K2/K3 rounds P and dS to the inputs' dtype before
the products that take them; the plain versions round at the same points.
Here the plain versions, at bf16, are held against the JAX backward
kernels in interpret mode (which keep P and dS in f32) on the same bf16
inputs, at the tolerance chip_smoke.py holds the card to: 2^-6 x the
largest JAX value. The plain K1 at bf16 is held against the JAX forward
kernel the same way (out at 2^-6 x max|JAX|, lse at 1e-4, and exactly
-1e30 on rows that see no key). The rounding is shown to be the identity
at f32, and the route rule (``kernels.fwd_route`` for K1,
``kernels.bwd_route`` for K2/K3) is checked as a pure function: which
dtype, head_dim, lengths and alignment go to which kernel, and that a CPU
tensor reaches none.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jattn = importlib.import_module("oim_tpu.ops.attention")
tattn = importlib.import_module("oim_tpu_torch.ops.attention")
from oim_tpu_torch import kernels  # noqa: E402

torch.set_num_threads(2)

BF16_REL_TOL = 2.0 ** -6  # chip_smoke.py's tolerance for bf16 outputs
BLOCK = 32  # the JAX kernels' block sizes here (lengths are multiples of it)


def _bf16_inputs(b, tq, tk, h, hkv, d, seed):
    """q, k, v, dO as bf16 numpy-made values: (jax arrays, torch tensors)."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*s).astype(np.float32)
            for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d), (b, tq, h, d))]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in jx]
    return jx, tx


BF16_CASES = [
    # (b, tq, tk, h, hkv, d, causal, lse cotangent)
    (1, 64, 64, 2, 2, 64, True, False),
    (1, 64, 64, 4, 1, 64, False, False),
    (2, 32, 96, 4, 2, 64, True, False),
    (1, 96, 64, 2, 1, 64, True, False),     # tq > tk: rows that see no key
    (1, 64, 64, 4, 2, 128, True, True),     # delta carries the lse cotangent
    (1, 64, 128, 2, 2, 32, False, True),
]


@pytest.mark.parametrize("b,tq,tk,h,hkv,d,causal,glse", BF16_CASES)
def test_plain_bwd_at_bf16_matches_jax_kernels(b, tq, tk, h, hkv, d, causal, glse):
    """The rounding points fit the card's tolerance: the plain K2/K3 (P and
    dS rounded to bf16) against the JAX kernels (P and dS in f32)."""
    (jq, jk, jv, jdo), (tq_, tk_, tv_, tdo) = _bf16_inputs(b, tq, tk, h, hkv, d, seed=tq + d)
    scale = d ** -0.5
    jout, jlse = jattn._flash_forward(jq, jk, jv, causal, scale, BLOCK, BLOCK, True)
    g_lse = np.random.RandomState(9).randn(b, tq, h).astype(np.float32) if glse else None
    jg_lse = (None if g_lse is None else
              jnp.asarray(g_lse).transpose(0, 2, 1).reshape(b * h, tq, 1))
    jgrads = jattn._flash_backward(jq, jk, jv, jout, jlse, jdo, causal, scale, BLOCK, BLOCK,
                                   True, g_lse=jg_lse)
    out = torch.tensor(np.asarray(jout.astype(jnp.float32))).to(torch.bfloat16)
    lse = torch.tensor(np.asarray(jlse)[..., 0])
    tgrads = tattn._backward(tq_, tk_, tv_, out, lse, tdo, causal, scale,
                             g_lse=None if g_lse is None else torch.tensor(g_lse))
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert t.dtype == torch.bfloat16
        want = np.asarray(j.astype(jnp.float32))
        err = float(np.abs(t.float().numpy() - want).max())
        tol = BF16_REL_TOL * float(np.abs(want).max())
        assert err <= tol, f"{name}: {err} > {tol}"


FWD_BF16_CASES = [
    # (b, tq, tk, h, hkv, d, causal)
    (1, 64, 64, 2, 2, 128, True),      # group 1, head_dim 128 (the main path's)
    (1, 64, 64, 4, 1, 64, False),      # group 4, full
    (2, 32, 96, 4, 1, 128, True),      # group 4, tq < tk
    (1, 64, 128, 2, 2, 64, False),     # group 1, full, tq < tk
    (1, 96, 64, 4, 1, 128, True),      # tq > tk: rows that see no key
    (1, 128, 64, 2, 2, 64, True),      # the same at head_dim 64, a whole tile blind
]


@pytest.mark.parametrize("b,tq,tk,h,hkv,d,causal", FWD_BF16_CASES)
def test_plain_fwd_at_bf16_matches_jax_kernel(b, tq, tk, h, hkv, d, causal):
    """The plain K1 at bf16 (P rounded to bf16 before PV, l from f32 p)
    against the JAX forward kernel in interpret mode on the same bf16
    inputs, at the card's tolerances; rows that see no key carry lse
    exactly -1e30 and out exactly 0 in both."""
    (jq, jk, jv, _), (tq_, tk_, tv_, _) = _bf16_inputs(b, tq, tk, h, hkv, d, seed=tq + tk + d)
    scale = d ** -0.5
    jout, jlse = jattn._flash_forward(jq, jk, jv, causal, scale, BLOCK, BLOCK, True)
    out, lse = tattn.flash_forward_plain(tq_, tk_, tv_, causal, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (b, tq, h, d)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, tq)
    want = np.asarray(jout.astype(jnp.float32))
    err = float(np.abs(out.float().numpy() - want).max())
    tol = BF16_REL_TOL * float(np.abs(want).max())
    assert err <= tol, f"out: {err} > {tol}"
    jl = np.asarray(jlse)[..., 0]
    assert float(np.abs(lse.numpy() - jl).max()) <= 1e-4
    blind = max(0, tq - tk) if causal else 0  # rows placed before key 0
    if blind:
        assert np.all(jl.reshape(b, h, tq)[..., :blind] == np.float32(-1e30))
        assert torch.all(lse.reshape(b, h, tq)[..., :blind] == -1e30)
        assert float(out[:, :blind].float().abs().max()) == 0.0
    assert bool(lse.reshape(b, h, tq)[..., blind:].isfinite().all())


def _unrounded(q, k, v, do, lse, delta, causal, scale):
    """K2/K3's plain arithmetic with P and dS kept in f32: (dq, dk, dv)."""
    b, tq, h, d = q.shape
    qg, kg, vg = tattn._grouped(q, k, v)
    dog = tattn._grouped(do, k, v)[0].float()
    p, ds = tattn._recompute(qg, kg, vg, dog, lse, delta, causal, scale)
    dv = (p.transpose(-1, -2) @ dog).sum(dim=2).permute(0, 2, 1, 3)
    dk = (ds.transpose(-1, -2) @ qg.float()).sum(dim=2).permute(0, 2, 1, 3)
    dq = (ds @ kg.float()).permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)
    return dq, dk, dv


def _plain_bwd_inputs(dtype, seed=3):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.tensor(rng.randn(*s).astype(np.float32)).to(dtype)
                   for s in ((1, 64, 4, 32), (1, 96, 2, 32), (1, 96, 2, 32), (1, 64, 4, 32)))
    out, lse = tattn.flash_forward_plain(q, k, v, True, 32 ** -0.5)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(4, 64).contiguous()
    return q, k, v, do, lse, delta


def test_bwd_rounding_is_the_identity_at_f32():
    args = _plain_bwd_inputs(torch.float32)
    x = torch.randn(5, 7)
    assert torch.equal(tattn._operand(x, torch.float32), x)
    dk, dv = tattn.flash_bwd_dkv_plain(*args, True, 32 ** -0.5)
    dq = tattn.flash_bwd_dq_plain(*args, True, 32 ** -0.5)
    udq, udk, udv = _unrounded(*args, True, 32 ** -0.5)
    assert torch.equal(dq, udq) and torch.equal(dk, udk) and torch.equal(dv, udv)


def test_bwd_rounding_is_applied_at_bf16():
    """At bf16 the plain K2/K3 differ from the unrounded arithmetic: P and
    dS really are rounded (and by no more than the card's tolerance)."""
    args = _plain_bwd_inputs(torch.bfloat16)
    dk, dv = tattn.flash_bwd_dkv_plain(*args, True, 32 ** -0.5)
    dq = tattn.flash_bwd_dq_plain(*args, True, 32 ** -0.5)
    exact = _unrounded(*args, True, 32 ** -0.5)
    diffs = [float((a.float() - e).abs().max()) for a, e in zip((dq, dk, dv), exact)]
    assert all(0 < dd <= BF16_REL_TOL * float(e.abs().max()) for dd, e in zip(diffs, exact))


# ------------------------------------------------------------- routes ----

ROUTE_CASES = [
    # (dtype, head_dim, tq, tk, route)
    (torch.bfloat16, 128, 2048, 2048, "wgmma"),
    (torch.bfloat16, 128, 200, 120, "wgmma"),   # ragged, tq > tk
    (torch.bfloat16, 64, 1, 1, "wgmma"),
    (torch.bfloat16, 64, 77, 130, "wgmma"),
    (torch.bfloat16, 96, 64, 64, "fma"),
    (torch.bfloat16, 32, 64, 64, "fma"),
    (torch.bfloat16, 40, 130, 70, "fma"),
    (torch.float32, 128, 64, 64, "fma"),
    (torch.float32, 64, 129, 129, "fma"),
    (torch.float32, 40, 130, 70, "fma"),
]


@pytest.mark.parametrize("dtype,d,tq,tk,route", ROUTE_CASES)
def test_route_rule_by_dtype_and_shape(dtype, d, tq, tk, route):
    q, do = torch.zeros(1, tq, 4, d, dtype=dtype), torch.zeros(1, tq, 4, d, dtype=dtype)
    k, v = torch.zeros(1, tk, 2, d, dtype=dtype), torch.zeros(1, tk, 2, d, dtype=dtype)
    assert kernels.bwd_route(q, k, v, do) == route


@pytest.mark.parametrize("dtype,d,tq,tk,route", ROUTE_CASES)
def test_fwd_route_rule_by_dtype_and_shape(dtype, d, tq, tk, route):
    """K1 follows the same rule as K2/K3 on q, k and v alone."""
    q = torch.zeros(1, tq, 4, d, dtype=dtype)
    k, v = torch.zeros(1, tk, 2, d, dtype=dtype), torch.zeros(1, tk, 2, d, dtype=dtype)
    assert kernels.fwd_route(q, k, v) == route
    assert kernels._pick_route(None, q, k, v) == route
    assert kernels._pick_route("fma", q, k, v) == "fma"


def test_fwd_route_sends_unaligned_data_to_fma():
    """Any of q, k, v off a 16-byte boundary sends K1 to the fma kernel."""
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    off = torch.zeros(1 * 8 * 2 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 2, 128)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert kernels.fwd_route(q, q, q) == "wgmma"
    for args in ((off, q, q), (q, off, q), (q, q, off)):
        assert kernels.fwd_route(*args) == "fma"
    with pytest.raises(ValueError, match="does not take"):
        kernels._pick_route("wgmma", off, q, q)


def test_route_rule_sends_unaligned_data_to_fma():
    """The wgmma kernels copy 16-byte chunks: a tensor that starts off a
    16-byte boundary goes to the fma kernel."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 2, 64)
    assert k.is_contiguous() and k.data_ptr() % 16
    assert kernels.bwd_route(q, q, q, q) == "wgmma"
    assert kernels.bwd_route(q, k, q, q) == "fma"


def test_named_route_must_take_the_call():
    q = torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16)
    assert kernels._pick_route(None, q, q, q, q) == "fma"
    assert kernels._pick_route("fma", q, q, q, q) == "fma"
    with pytest.raises(ValueError, match="does not take"):
        kernels._pick_route("wgmma", q, q, q, q)


@pytest.mark.parametrize("name,route", [("flash_fwd", "tf32"), ("flash_bwd_dq", "tf32")])
def test_kernel_info_refuses_what_has_no_route(name, route):
    """Each kernel has a "wgmma" and an "fma" route and nothing else; the
    refusal comes before any build (there is no nvcc here)."""
    with pytest.raises(ValueError, match="no route"):
        kernels.kernel_info(name, route, 128)


@pytest.mark.parametrize("fn", [kernels.flash_bwd_dkv, kernels.flash_bwd_dq, kernels.flash_fwd])
def test_cpu_tensors_reach_no_kernel(fn):
    """A CPU tensor is refused by the wrappers before any route is taken."""
    q = torch.zeros(1, 64, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    rows = torch.zeros(4, 64)
    kernels.reset_launches()
    args = ((q, k, k, True, 128 ** -0.5) if fn is kernels.flash_fwd else
            (q, k, k, q, rows, rows, True, 128 ** -0.5))
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert all(c == 0 for r in kernels.ROUTES.values() for c in r.values())
    assert all(c == 0 for c in kernels.LAUNCHES.values())


def test_cpu_backward_runs_the_plain_versions(monkeypatch):
    """On the CPU the autograd backward never calls a kernel wrapper, even
    at a shape the wgmma route would take on the card."""
    def boom(*a, **kw):
        raise AssertionError("a kernel wrapper was called for a CPU tensor")

    monkeypatch.setattr(kernels, "flash_bwd_dkv", boom)
    monkeypatch.setattr(kernels, "flash_bwd_dq", boom)
    monkeypatch.setattr(kernels, "flash_fwd", boom)
    kernels.reset_launches()
    rng = np.random.RandomState(4)
    q, k, v = (torch.tensor(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
               .requires_grad_(True) for s in ((1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)))
    out = tattn.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert all(g.dtype == torch.bfloat16 and bool(g.isfinite().all()) for g in grads)
    assert all(c == 0 for r in kernels.ROUTES.values() for c in r.values())


def test_reset_launches_zeroes_every_route_count():
    kernels.ROUTES["flash_bwd_dkv"]["wgmma"] = 3
    kernels.ROUTES["flash_bwd_dq"]["fma"] = 2
    kernels.LAUNCHES["flash_fwd"] = 1
    kernels.reset_launches()
    assert set(kernels.ROUTES) == set(kernels.LAUNCHES) == set(kernels.SOURCES)
    assert all(c == 0 for r in kernels.ROUTES.values() for c in r.values())
    assert all(c == 0 for c in kernels.LAUNCHES.values())
