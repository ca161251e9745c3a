"""The port's Mixture-of-Experts family held against the JAX package's, on
the CPU: ``models/moe.py`` in both dispatch modes, llama-tiny-moe's loss,
gradients and trainer steps, MoE decoding (dense cache, paged steps, the
engine), the parameter and FLOP counts, ``ops.norms.layernorm`` and
``cli/oim_infer``. JAX weights cross with ``from_numpy``; inputs come from
numpy seeds.

Tolerances are tests/test_ops.py's at f32: forward 2e-5 absolute,
gradients 2e-4 absolute (plus 1e-5 / 1e-4 relative: two frameworks' f32
products sum in different orders). A route is an argmax, so every
fixture's smallest top-k router margin is asserted above 1e-4: f32
reordering (~1e-7) cannot flip a route there. Greedy tokens, drop
fractions and parameter counts must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oim_tpu.models import generate as jgen
from oim_tpu.models import llama as jllama
from oim_tpu.models import moe as jmoe
from oim_tpu.ops import norms as jnorms
from oim_tpu.serve import weights as jweights
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.cli import oim_infer as tinfer
from oim_tpu_torch.cli import oim_trainer as tcli
from oim_tpu_torch.models import generate as tgen
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.models import moe as tmoe
from oim_tpu_torch.models import remat as trematlib
from oim_tpu_torch.ops import norms as tnorms
from oim_tpu_torch.serve import ServeEngine
from oim_tpu_torch.serve import weights as tweights
from oim_tpu_torch.train import state as tstate
from oim_tpu_torch.train import trainer as ttrainer
from oim_tpu_torch.train.checkpoint import Checkpointer

torch.set_num_threads(2)

FWD = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=2e-4, rtol=1e-4)
MARGIN = 1e-4
CONFIGS = [(4, 2, 1.25), (8, 1, 1.0), (4, 2, 0.5), (2, 1, 0.25)]
FLAGSHIP = dict(vocab=32768, dim=2048, n_layers=8, n_heads=16, n_kv_heads=8, head_dim=128,
                mlp_dim=8192, max_seq=8192, n_experts=4, moe_top_k=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=FWD, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _carry(jtree):
    return tllama.from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# --------------------------------------------------------------- moe.apply --


def _moe_fixture(e, k, cf, dispatch="gather", dim=32, mlp=64, shape=(2, 16), seed=0,
                 shift=0.0):
    jcfg = jmoe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf, dispatch=dispatch)
    tcfg = tmoe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf, dispatch=dispatch)
    jp = jmoe.init(jax.random.PRNGKey(seed), dim, mlp, jcfg, jnp.float32)
    x = np.random.RandomState(seed + 1).randn(*shape, dim).astype(np.float32) + shift
    return jcfg, tcfg, jp, _carry(jp), x


def test_config_fields_and_capacity_match_jax():
    assert ({f.name: f.default for f in dataclasses.fields(jmoe.MoEConfig)}
            == {f.name: f.default for f in dataclasses.fields(tmoe.MoEConfig)})
    for n in (1, 7, 32, 4096):
        for e, k, cf in CONFIGS + [(4, 2, 2.0), (3, 2, 1.5)]:
            jc = jmoe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf)
            tc = tmoe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf)
            assert tmoe.capacity(n, tc) == jmoe.capacity(n, jc)
    cfg = dataclasses.replace(tllama.tiny(n_experts=4), moe_dispatch="einsum")
    assert cfg.moe == tmoe.MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25,
                                     dispatch="einsum")


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("e,k,cf", CONFIGS)
def test_apply_and_gradients_match_jax(e, k, cf, dispatch):
    jcfg, tcfg, jp, tp, x = _moe_fixture(e, k, cf, dispatch)
    jout, jstats = jax.jit(lambda p, x: jmoe.apply(p, x, jcfg, with_stats=True))(
        jp, jnp.asarray(x))
    leaves = list(tp.values())
    for p in leaves:
        p.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    tout, tstats = tmoe.apply(tp, xt, tcfg, with_stats=True)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    _close(tout, jout)
    _close(tstats[0], jstats[0])
    assert float(tstats[1].detach()) == float(jstats[1])  # a count: exact
    dropped_grads = torch.autograd.grad(tstats[1], leaves + [xt], retain_graph=True,
                                        allow_unused=True)
    assert not any(g is not None and g.any() for g in dropped_grads)  # no gradient
    out2, aux = tmoe.apply(tp, xt, tcfg)
    assert torch.equal(out2, tout) and torch.equal(aux, tstats[0])

    def jloss(p, x):
        out, st = jmoe.apply(p, x, jcfg, with_stats=True)
        return jnp.sum(out * out) + st[0]

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tg = torch.autograd.grad((tout * tout).sum() + tstats[0], leaves + [xt])
    for name, g in zip(tp, tg):
        _close(g, jg[name], GRAD, msg=name)
    _close(tg[-1], jgx, GRAD, msg="x")


@pytest.mark.parametrize("e,k,cf", CONFIGS)
def test_fixture_routes_are_far_from_ties(e, k, cf):
    _, _, _, tp, x = _moe_fixture(e, k, cf)
    assert float(tmoe.router_margin(tp["router"], torch.tensor(x), k)) > MARGIN


@pytest.mark.parametrize("set_only", [False, True], ids=["top-k gaps", "k-th gap"])
def test_router_margin_is_the_least_gap_among_the_top_k_plus_one(set_only):
    """moe.router_margin against a per-token numpy loop over the JAX
    fixture's router probabilities."""
    _, _, jp, tp, x = _moe_fixture(4, 2, 1.25)
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(jp["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = min(min(row[i] - row[i + 1] for i in ((1,) if set_only else (0, 1)))
               for row in np.sort(probs, -1)[:, ::-1])
    got = tmoe.router_margin(tp["router"], torch.tensor(x), 2, set_only=set_only)
    assert got.shape == () and abs(float(got) - want) < 1e-6


@pytest.mark.parametrize("e,k,cf", [(4, 2, 1.25), (8, 1, 1.0), (4, 2, 0.5)])
def test_gather_matches_einsum(e, k, cf):
    """tests/test_pipeline_moe.py's dispatch identity, in the port."""
    _, cfg_e, _, tp, x = _moe_fixture(e, k, cf, "einsum")
    cfg_g = dataclasses.replace(cfg_e, dispatch="gather")
    xt = torch.tensor(x)
    out_e, aux_e = tmoe.apply(tp, xt, cfg_e)
    out_g, aux_g = tmoe.apply(tp, xt, cfg_g)
    torch.testing.assert_close(out_g, out_e, atol=1e-6, rtol=0)
    torch.testing.assert_close(aux_g, aux_e, atol=1e-7, rtol=0)
    grads = {}
    for cfg in (cfg_e, cfg_g):
        leaves = [p.detach().requires_grad_(True) for p in tp.values()]
        grads[cfg.dispatch] = torch.autograd.grad(
            tmoe.apply(dict(zip(tp, leaves)), xt, cfg)[0].sum(), leaves)
    for name, a, b in zip(tp, grads["einsum"], grads["gather"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0, msg=name)


def test_dropped_tokens_never_corrupt_slots():
    """Skewed inputs route most tokens to one expert of two at capacity
    8 of 64: the dump column takes the drops, never slot cap-1."""
    jcfg, cfg_e, jp, tp, x = _moe_fixture(2, 1, 0.25, "einsum", dim=16, mlp=32,
                                          shape=(1, 64), seed=2, shift=1.0)
    cfg_g = dataclasses.replace(cfg_e, dispatch="gather")
    xt = torch.tensor(x)
    out_e, st_e = tmoe.apply(tp, xt, cfg_e, with_stats=True)
    out_g, st_g = tmoe.apply(tp, xt, cfg_g, with_stats=True)
    assert float(st_g[1]) > 0.5  # heavy drops
    torch.testing.assert_close(out_g, out_e, atol=1e-6, rtol=0)
    jcfg = dataclasses.replace(jcfg, dispatch="gather")
    jout, _ = jax.jit(lambda p, x: jmoe.apply(p, x, jcfg))(jp, jnp.asarray(x))
    _close(out_g, jout)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_apply_never_syncs_the_host(dispatch):
    """No .item(), nonzero or boolean-mask indexing: the shapes stay static
    and the host never waits on the device, forward or backward."""
    _, tcfg, _, tp, x = _moe_fixture(4, 2, 0.5, dispatch)
    leaves = [p.requires_grad_(True) for p in tp.values()]
    xt = torch.tensor(x, requires_grad=True)
    with _OpLog() as log:
        out, stats = tmoe.apply(tp, xt, tcfg, with_stats=True)
        torch.autograd.grad(out.sum() + stats[0], leaves + [xt])
    assert {"bmm", "mm"} & log.ops
    host = {"_local_scalar_dense", "item", "nonzero", "masked_select", "is_nonzero",
            "equal", "unique", "_unique2"}
    assert not host & log.ops, host & log.ops


# ------------------------------------------------------------- llama + MoE --


def _llama(dispatch="gather", **kw):
    jcfg = dataclasses.replace(jllama.tiny(n_experts=4), moe_dispatch=dispatch, **kw)
    tcfg = dataclasses.replace(tllama.tiny(n_experts=4), moe_dispatch=dispatch, **kw)
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _carry(jp)


def test_init_tree_matches_jax():
    jcfg, tcfg, jp, _ = _llama()
    tp = tllama.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jf = _flat(jax.tree.map(np.asarray, jp))
    tf = {k: v.detach().numpy() for k, v in _flat(tp).items()}
    assert jf.keys() == tf.keys() and "/layers/moe/router" in tf and "/layers/w_up" not in tf
    for k in jf:
        assert jf[k].shape == tf[k].shape and jf[k].dtype == tf[k].dtype, k
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    bf = tllama.init(torch.Generator().manual_seed(0),
                     dataclasses.replace(tcfg, dtype=torch.bfloat16), device="cpu")
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    assert bf["layers"]["moe"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_loss_stats_and_gradients_match_jax(dispatch, monkeypatch):
    jcfg, tcfg, jp, tp = _llama(dispatch)
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 17)).astype(np.int32)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_and_stats(p, jnp.asarray(tokens), jcfg), has_aux=True))(jp)
    seen = []
    apply = tmoe.apply

    def spy(params, x, cfg, with_stats=False):
        seen.append(float(tmoe.router_margin(params["router"], x, cfg.top_k)))
        return apply(params, x, cfg, with_stats)

    monkeypatch.setattr(tmoe, "apply", spy)
    leaves = list(tstate.tree_leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    tloss, tstats = tllama.loss_and_stats(tp, torch.tensor(tokens), tcfg)
    tgrads = torch.autograd.grad(tloss, leaves)
    assert len(seen) == tcfg.n_layers and min(seen) > MARGIN
    _close(tloss, jloss)
    assert tstats.keys() == jstats.keys() == {"moe_drop_frac"}
    assert float(tstats["moe_drop_frac"].detach()) == float(jstats["moe_drop_frac"]) > 0
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    tflat = _flat(tstate.tree_unflatten(tp, tgrads))
    assert jflat.keys() == tflat.keys()
    for k, g in jflat.items():
        _close(tflat[k], g, GRAD, msg=k)


@pytest.mark.parametrize("cfg", ["tiny-moe", "flagship"])
def test_param_and_flop_counts_match_jax(cfg):
    if cfg == "flagship":
        jc = dataclasses.replace(jllama.LLAMA3_8B, **FLAGSHIP)
        tc = dataclasses.replace(tllama.LLAMA3_8B, **FLAGSHIP)
        assert tllama.num_params(tc) == 1_845_594_112
        assert tllama.num_active_params(tc) == 1_040_287_744
        flops = tllama.num_flops_per_token(tc, 2048) * 2 * 2048
        assert 27.1e12 < flops < 27.3e12
    else:
        jc, tc = jllama.tiny(n_experts=4), tllama.tiny(n_experts=4)
        tp = tllama.init(torch.Generator().manual_seed(0), tc, device="cpu")
        assert tllama.num_params(tc) == sum(t.numel() for t in tstate.tree_leaves(tp))
    assert tllama.num_params(tc) == jllama.num_params(jc)
    assert tllama.num_active_params(tc) == jllama.num_active_params(jc)
    assert tllama.num_active_params(tc) < tllama.num_params(tc)
    for seq in (None, 2048):
        assert tllama.num_flops_per_token(tc, seq) == jllama.num_flops_per_token(jc, seq)
    dense = tllama.tiny()
    assert tllama.num_active_params(dense) == tllama.num_params(dense)


# ---------------------------------------------------------------- trainer --


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_trainer_steps_and_drop_frac_match_jax_trainer(accum_steps):
    common = dict(model="llama-tiny-moe", batch_size=4, seq_len=16, lr=1e-2,
                  warmup_steps=1, total_steps=10, log_every=1, seed=3,
                  accum_steps=accum_steps)
    jcfg, tcfg = jtrainer.TrainConfig(**common), ttrainer.TrainConfig(**common)
    assert tcfg.model_config() == dataclasses.replace(
        tllama.tiny(n_experts=4), dtype=torch.float32)
    assert ttrainer.flops_per_step(tcfg) == jtrainer.flops_per_step(jcfg)
    jtr = jtrainer.Trainer(jcfg, axes=[("data", 1)])
    jtr.init_or_resume()
    init = jax.tree.map(np.asarray, jtr.state.params)
    ttr = ttrainer.Trainer(tcfg, device="cpu")
    ttr.init(tllama.from_numpy(init, device="cpu"))
    assert ttr.state.opt_state.mu["layers"]["moe"]["router"].dtype == torch.float32
    jdata, tdata = jtrainer.synthetic_batches(jcfg), ttrainer.synthetic_batches(tcfg)
    for step in range(3):
        jtr.state, js = jtr.step_fn(jtr.state, jtr.place_batch(next(jdata)))
        ttr.state, ts = ttr.step_fn(ttr.state, ttr.place_batch(next(tdata)))
        np.testing.assert_allclose(float(ts["loss"]), float(js["loss"]), atol=1e-4,
                                   err_msg=f"step {step + 1}")
        np.testing.assert_allclose(float(ts["grad_norm"]), float(js["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {step + 1}")
        np.testing.assert_allclose(float(ts["moe_drop_frac"]), float(js["moe_drop_frac"]),
                                   atol=1e-7, err_msg=f"step {step + 1}")
    ttr.evaluate(ttrainer.synthetic_batches(dataclasses.replace(tcfg, seed=9)), 1)
    assert 0.0 <= ttr.last_eval_stats["moe_drop_frac"] < 1.0


def test_trainer_history_and_checkpoint_carry_the_nested_tree(tmp_path):
    tr = tcli.run(["--model", "llama-tiny-moe", "--device", "cpu", "--steps", "2",
                   "--batch-size", "2", "--seq-len", "8", "--log-every", "1",
                   "--checkpoint-dir", str(tmp_path), "--log-level", "error"])
    assert [0.0 <= r["moe_drop_frac"] < 1.0 for r in tr.history] == [True, True]
    back = Checkpointer(str(tmp_path)).restore()
    assert back.step == 2 and back.opt_state.count == 2
    for name, a, b in (("params", tr.state.params, back.params),
                       ("mu", tr.state.opt_state.mu, back.opt_state.mu),
                       ("nu", tr.state.opt_state.nu, back.opt_state.nu)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys() and "/layers/moe/w_gate" in fa, name
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k].detach(), fb[k]), k


# ------------------------------------------------------------------ remat --


def _remat_loss_and_grads(policy=None):
    cfg = tllama.tiny(n_experts=4)
    if policy is not None:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    params = tllama.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = list(tstate.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (2, 17)))
    loss, stats = tllama.loss_and_stats(params, tokens, cfg)
    return loss.detach(), stats["moe_drop_frac"], torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("policy", ["", "nothing", "dots", "dots_with_no_batch_dims"])
def test_remat_changes_no_loss_or_gradient(policy):
    loss, drop, grads = _remat_loss_and_grads()
    rloss, rdrop, rgrads = _remat_loss_and_grads(policy)
    assert torch.equal(loss, rloss) and torch.equal(drop, rdrop)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))


class _BmmCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_expert_products_and_no_batch_dims_recomputes_them():
    """The three expert products are bmm (batch dim E): "dots" keeps their
    outputs, "dots_with_no_batch_dims" and plain remat recompute them in
    the backward, as JAX's policies do."""
    _, tcfg, _, tp, x = _moe_fixture(4, 2, 1.25)
    backward_bmm = {}
    for policy in (None, "", "nothing", "dots", "dots_with_no_batch_dims"):
        leaves = [p.detach().requires_grad_(True) for p in tp.values()]
        params = dict(zip(tp, leaves))
        xt = torch.tensor(x, requires_grad=True)
        if policy is None:
            out, _ = tmoe.apply(params, xt, tcfg)
        else:
            out, _ = trematlib.checkpoint(tmoe.apply, params, xt, tcfg, policy=policy)
        with _BmmCount() as count:
            torch.autograd.grad(out.sum(), leaves + [xt])
        backward_bmm[policy] = count.n
    base = backward_bmm[None]
    assert backward_bmm == {None: base, "": base + 3, "nothing": base + 3, "dots": base,
                            "dots_with_no_batch_dims": base + 3}


# --------------------------------------------------------------- decoding --


@pytest.fixture(scope="module")
def small():
    """llama.tiny MoE at the serving tests' size (vocab 64, dim 32)."""
    jcfg = jllama.tiny(vocab=64, dim=32, n_layers=2, n_experts=4)
    tcfg = tllama.tiny(vocab=64, dim=32, n_layers=2, n_experts=4)
    jp = jllama.init(jax.random.PRNGKey(7), jcfg)
    return jp, _carry(jp), jcfg, tcfg


def _rollout_nocache(params, prompt, n_new, cfg):
    """tests/test_models.py's reference, on the port's llama.apply (held
    to JAX's above): full forwards, no cache."""
    seq = prompt
    for _ in range(n_new):
        nxt = tllama.apply(params, seq, cfg)[:, -1].argmax(dim=-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    return seq


def test_generate_greedy_equals_jax_and_the_no_drop_rollout(small):
    jp, tp, jcfg, tcfg = small
    prompt = np.random.RandomState(8).randint(0, 64, (2, 3)).astype(np.int32)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), 4, jcfg))
    no_drop = dataclasses.replace(tcfg, moe_capacity_factor=tcfg.n_experts / tcfg.moe_top_k)
    with torch.no_grad():
        rollout = _rollout_nocache(tp, torch.tensor(prompt).long(), 4, no_drop)
    got = tgen.generate(tp, torch.tensor(prompt).long(), 4, tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, rollout)


def test_cached_forward_logits_match_jax(small):
    jp, tp, jcfg, tcfg = small
    prompt = np.random.RandomState(2).randint(0, 64, (2, 7)).astype(np.int32)
    jcache, tcache = jgen.init_cache(jcfg, 2, 12), tgen.init_cache(tcfg, 2, 12, device="cpu")
    jl, jcache = jgen.cached_forward(jp, jnp.asarray(prompt), jcache, 0, jcfg)
    tl, tcache = tgen.cached_forward(tp, torch.tensor(prompt), tcache, 0, tcfg)
    _close(tl, jl)
    tok = np.array([[3], [60]], np.int32)
    jl, _ = jgen.cached_forward(jp, jnp.asarray(tok), jcache, 7, jcfg)
    tl, _ = tgen.cached_forward(tp, torch.tensor(tok), tcache, 7, tcfg)
    _close(tl, jl)


PAGE = 4


def test_paged_prefill_decode_and_verify_match_jax(small):
    jp, tp, jcfg, tcfg = small
    rng = np.random.RandomState(4)
    jpool = jgen.init_page_pool(jcfg, 10, PAGE)
    tpool = tgen.init_page_pool(tcfg, 10, PAGE, device="cpu")
    tables = np.array([[1, 2, 3, 4], [7, 5, 9, 6]], np.int32)  # S = 16
    for row, n in ((0, 6), (1, 9)):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = rng.randint(0, 64, n)
        jl, jpool = jgen.prefill_into_pages(jp, jnp.asarray(padded), jnp.int32(n), jpool,
                                            jnp.asarray(tables[row]), jnp.int32(0), jcfg,
                                            PAGE)
        tl, tpool = tgen.prefill_into_pages(tp, torch.tensor(padded), n, tpool,
                                            torch.tensor(tables[row]), 0, tcfg, PAGE)
        _close(tl, jl, msg=f"prefill row {row}")
    pos = np.array([6, 9], np.int32)
    for step in range(2):
        tok = rng.randint(0, 64, 2).astype(np.int32)
        jl, jpool = jgen.decode_step(jp, jnp.asarray(tok), jpool, jnp.asarray(tables),
                                     jnp.asarray(pos), jcfg, PAGE)
        tl, tpool = tgen.decode_step(tp, torch.tensor(tok), tpool, torch.tensor(tables),
                                     torch.tensor(pos), tcfg, PAGE)
        _close(tl, jl, msg=f"decode step {step}")
        pos = pos + 1
    cand = rng.randint(0, 64, (2, 4)).astype(np.int32)
    jl, jpool = jgen.verify_step(jp, jnp.asarray(cand), jpool, jnp.asarray(tables),
                                 jnp.asarray(pos), jcfg, PAGE)
    tl, tpool = tgen.verify_step(tp, torch.tensor(cand), tpool, torch.tensor(tables),
                                 torch.tensor(pos), tcfg, PAGE)
    assert tl.shape == (2, 4, 64)
    _close(tl, jl, msg="verify")
    for key in ("k", "v"):
        _close(tpool[key][:, 1:], jpool[key][:, 1:])


def test_engine_greedy_streams_equal_jax_generate(small):
    jp, tp, jcfg, tcfg = small
    rs = np.random.RandomState(3)
    shared = rs.randint(0, 64, 8).tolist()
    reqs = [rs.randint(0, 64, n).tolist() for n in (9, 3, 9)]
    reqs += [shared + [i] for i in (5, 6)]
    want = [np.asarray(jgen.generate(jp, jnp.asarray([p], jnp.int32), 6, jcfg,
                                     max_seq=64))[0, len(p):].tolist() for p in reqs]
    eng = ServeEngine(tp, tcfg, max_batch=2, max_seq=64, prefix_block=4, device="cpu")
    try:
        handles = [eng.submit(p, max_new=6) for p in reqs[:4]]
        outs = [h.result(timeout=60) for h in handles]
        outs.append(eng.submit(reqs[4], max_new=6).result(timeout=60))  # a prefix hit
        hits = eng.request_stats()["prefix_hits"]
    finally:
        eng.stop()
    assert outs == want
    assert hits >= 1


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pack_params_is_byte_identical_to_jax(small, dtype):
    jp = jax.tree.map(lambda x: x.astype(dtype) if x.ndim > 1 else x, small[0])
    raw = lambda x: (np.asarray(x).view(np.uint16).view("V2")  # noqa: E731
                     if x.dtype == jnp.bfloat16 else np.asarray(x))
    jblob = jweights.pack_params(jax.tree.map(raw, jp))
    assert b"['layers']['moe']['router']" in jblob
    tp = _carry(jp)
    assert tweights.pack_params(tp) == jblob
    assert tweights.pack_params(tweights.unpack_params(jblob, device="cpu")) == jblob


# -------------------------------------------------------------- layernorm --


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype, with_bias):
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 7, 48) * 3 + 1).astype(np.float32)
    w = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32) if with_bias else None
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jnorms.layernorm(jnp.asarray(x, jd), jnp.asarray(w),
                            None if b is None else jnp.asarray(b))
    got = tnorms.layernorm(torch.tensor(x).to(td), torch.tensor(w),
                           None if b is None else torch.tensor(b))
    assert got.dtype == td and got.shape == x.shape
    if dtype == "float32":
        _close(got, want)
    else:  # one bf16 rounding of the same f32 value, at most one step apart
        _close(got, want, dict(atol=0, rtol=2.0 ** -7))


# -------------------------------------------------------------- oim-infer --


def test_oim_infer_decodes_a_port_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    tcli.run(["--model", "llama-tiny-moe", "--device", "cpu", "--steps", "1",
              "--batch-size", "2", "--seq-len", "8", "--checkpoint-dir", ck,
              "--log-level", "error"])
    capsys.readouterr()
    assert tinfer.main(["--checkpoint-dir", ck, "--model", "llama-tiny-moe",
                        "--prompt", "1,2,3;40,50,60", "--n-new", "5", "--device", "cpu",
                        "--log-level", "error"]) == 0
    rows = [[int(t) for t in line.split(",")] for line in capsys.readouterr().out.split()]
    params = Checkpointer(ck).restore().params
    want = tgen.generate(params, torch.tensor([[1, 2, 3], [40, 50, 60]]), 5,
                         ttrainer.TrainConfig(model="llama-tiny-moe").model_config())
    assert rows == want.tolist()
    assert tinfer.main(["--checkpoint-dir", ck, "--model", "llama-tiny-moe", "--n-new", "3",
                        "--device", "cpu", "--log-level", "error"]) == 0
    (row,) = capsys.readouterr().out.split()
    assert len(row.split(",")) == 8 + 3


def test_oim_infer_refuses_a_directory_without_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit) as exc:
        tinfer.main(["--checkpoint-dir", str(tmp_path), "--model", "llama-tiny-moe",
                     "--device", "cpu", "--log-level", "error"])
    assert exc.value.code not in (0, None)
    assert tinfer.parse_args(["--checkpoint-dir", "x"]).device == "cuda"
