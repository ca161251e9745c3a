"""The port's llama (oim_tpu_torch.models.llama) held against the JAX
package's on llama.tiny, on the CPU: JAX-initialized weights carried
across with from_numpy, the same numpy tokens through both, fp32.

Tolerances: logits and loss 2e-5 absolute plus 1e-5 relative (two
framework's f32 matmuls and the flash plain version against JAX's
reference attention sum in different orders); gradients 2e-4 absolute
plus 1e-4 relative, test_ops.py's gradient tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import llama as jllama
from oim_tpu.serve import weights as jweights
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.serve import weights as tweights

torch.set_num_threads(2)

FWD = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=2e-4, rtol=1e-4)


def _configs(**kw):
    jcfg = dataclasses.replace(jllama.tiny(), **kw)
    tcfg = dataclasses.replace(tllama.tiny(), **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jllama.init(jax.random.PRNGKey(seed), jcfg)
    return jp, tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(jcfg, b=2, t=17, seed=0):
    return np.random.RandomState(seed).randint(0, jcfg.vocab, (b, t)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def test_config_fields_match_jax():
    jf = {f.name for f in dataclasses.fields(jllama.Config)}
    tf = {f.name for f in dataclasses.fields(tllama.Config)}
    assert jf == tf
    for name in jf - {"dtype"}:
        assert getattr(jllama.LLAMA3_8B, name) == getattr(tllama.LLAMA3_8B, name), name
        assert getattr(jllama.tiny(), name) == getattr(tllama.tiny(), name), name
    assert tllama.LLAMA3_8B.dtype == torch.bfloat16 and tllama.tiny().dtype == torch.float32


def test_counts_match_jax():
    for jc, tc in ((jllama.LLAMA3_8B, tllama.LLAMA3_8B), (jllama.tiny(), tllama.tiny())):
        assert tllama.num_params(tc) == jllama.num_params(jc)
        assert tllama.num_flops_per_token(tc, 2048) == jllama.num_flops_per_token(jc, 2048)
    two = dataclasses.replace(tllama.LLAMA3_8B, n_layers=2)
    assert 1.4e9 < tllama.num_params(two) < 1.6e9


def test_init_shapes_and_dtypes_match_jax():
    jcfg, tcfg = _configs()
    jp = jax.eval_shape(lambda: jllama.init(jax.random.PRNGKey(0), jcfg))
    tp = tllama.init(torch.Generator().manual_seed(0), tcfg)
    jf, tf = _flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp)), _flat(tp)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert jf[k].shape == tf[k].shape and jf[k].dtype == tf[k].dtype, k


def test_apply_logits_match_jax():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    tokens = _tokens(jcfg)
    jl = jllama.apply(jp, jnp.asarray(tokens), jcfg)
    tl = tllama.apply(tp, torch.tensor(tokens), tcfg)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **FWD)


@pytest.mark.parametrize("vocab_chunk,z_loss", [(0, 0.0), (0, 1e-3), (96, 1e-3)])
def test_loss_and_every_gradient_leaf_match_jax(vocab_chunk, z_loss):
    """vocab 256 in chunks of 96 is not a multiple: the ragged last chunk."""
    jcfg, tcfg = _configs(vocab_chunk=vocab_chunk, z_loss=z_loss)
    jp, tp = _params(jcfg, seed=1)
    tokens = _tokens(jcfg, seed=1)
    tokens[0, -1] = -1  # an ignored label (a label only, never an input)

    (jloss, jstats), jgrads = jax.value_and_grad(
        lambda p: jllama.loss_and_stats(p, jnp.asarray(tokens), jcfg), has_aux=True)(jp)
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    tloss, tstats = tllama.loss_and_stats(tp, torch.tensor(tokens), tcfg)
    np.testing.assert_allclose(tloss.item(), float(jloss), **FWD)
    assert tstats.keys() == jstats.keys()
    for k in jstats:
        np.testing.assert_allclose(tstats[k].item(), float(jstats[k]), **FWD)
    leaves = jax.tree.leaves(tp)  # sorted-key order, as flattened below
    tgrads = dict(zip(sorted(_flat(tp)), torch.autograd.grad(tloss, leaves)))
    jflat = _flat(jgrads)
    assert jflat.keys() == tgrads.keys()
    for k, g in jflat.items():
        np.testing.assert_allclose(tgrads[k].numpy(), g, err_msg=k, **GRAD)


def test_loss_fn_is_loss_of_loss_and_stats():
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg)
    tokens = torch.tensor(_tokens(jcfg))
    assert float(tllama.loss_fn(tp, tokens, tcfg)) == float(
        tllama.loss_and_stats(tp, tokens, tcfg)[0])


def test_unported_options_refuse():
    cfg = dataclasses.replace(tllama.tiny(), remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.hidden_states({}, torch.zeros((1, 4), dtype=torch.long), cfg)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pack_params_is_byte_identical_to_jax(dtype):
    jcfg, _ = _configs()
    jp = jax.tree.map(lambda x: x.astype(dtype), jllama.init(jax.random.PRNGKey(2), jcfg))
    # A bf16 leaf goes to the JAX packer as numpy's raw void16 view (an
    # ml_dtypes array exports no buffer); it names it "bfloat16".
    raw = lambda x: (np.asarray(x).view(np.uint16).view("V2")  # noqa: E731
                     if x.dtype == jnp.bfloat16 else np.asarray(x))
    jblob = jweights.pack_params(jax.tree.map(raw, jp))
    assert (b'"bfloat16"' in jblob) == (dtype == jnp.bfloat16)
    tp = tllama.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tweights.pack_params(tp) == jblob
    # and back: the port unpacks the JAX blob into the same tensors
    back = tweights.unpack_params(jblob, device="cpu")
    assert tweights.pack_params(back) == jblob
    # numpy round trip through to_numpy (bf16 as uint16 bits)
    again = tllama.from_numpy(tllama.to_numpy(tp), device="cpu")
    assert tweights.pack_params(again) == jblob
