"""The port's ResNet-50 (oim_tpu_torch.models.resnet) held against the JAX
package's on the CPU: seeded numpy weights and images through both, the
weights carried with from_numpy, f32. ``width`` sets only the stem (the
stage widths are fixed), so every case runs the whole 25.6 M-param net at
a small image.

Tolerances, as max|diff| over max|reference| of each tensor:

* inference mode, the whole net at 32x32, batch 2: logits 1e-4, every
  param's gradient 2e-4 (batch norm is then a fixed affine map);
* training mode, each bottleneck given the same input and cotangent in
  both packages at 64x64, batch 4: output and new BN state 1e-4, input
  and param gradients 2e-4 (the worst reads 1.6e-5); the cotangent is 0
  where the output lies within 1e-4 of the final ReLU's kink;
* training mode, the whole net at 64x64, batch 4: logits 2e-3 and BN
  state 1e-3 (read: 2.8e-4 and 1.1e-4). Batch statistics over a few
  samples amplify f32 rounding through 53 batch norms, and the gradients
  most: against JAX's f64 evaluation of the same net, JAX's own f32
  whole-net gradients err by up to 5.6e-2 of a leaf (relative L2) and the
  port's by 1.8e-2, so the port's are held to within twice JAX's error of
  that truth, and the port's f64 evaluation to the truth at 1e-8 (read:
  1.3e-12).
  At 32x32 and batch 2 the last stage normalizes over 2 samples (1x1
  spatial), where a last-bit difference turns into O(1): the training
  cases run at 64x64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import resnet as jresnet
from oim_tpu.ops import losses as jlosses
from oim_tpu.ops.losses import softmax_cross_entropy as jce
from oim_tpu_torch.models import resnet as tresnet
from oim_tpu_torch.ops.losses import softmax_cross_entropy as tce
from oim_tpu_torch.train.state import tree_leaves, tree_unflatten

torch.set_num_threads(2)

JCFG = jresnet.Config(num_classes=10, dtype=jnp.float32)
TCFG = tresnet.Config(num_classes=10, dtype=torch.float32)
F64_TOL = 1e-8


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - np.asarray(got, np.float64)).max() / np.abs(ref).max())


def _fill(tree, rs, path=()):
    """Seeded numpy values for a tree of shapes: He-scaled conv kernels, a
    fan-in-scaled head, and BN scale/var near 1, bias/mean near 0 (so that
    inference mode exercises every term)."""
    if isinstance(tree, dict):
        return {k: _fill(v, rs, path + (k,)) for k, v in tree.items()}
    shape = tree.shape
    if len(shape) == 4:
        return (rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
    if len(shape) == 2:
        return (rs.randn(*shape) * shape[0] ** -0.5).astype(np.float32)
    if path[-1] in ("scale", "var"):
        return (1.0 + 0.2 * rs.rand(*shape)).astype(np.float32)
    return (0.1 * rs.randn(*shape)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    shapes = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), JCFG))
    rs = np.random.RandomState(0)
    return _fill(shapes[0], rs), _fill(shapes[1], rs)


def _images(b, s, seed=1):
    return np.random.RandomState(seed).rand(b, s, s, 3).astype(np.float32)


def _port(params, state):
    p = tresnet.from_numpy(params, device="cpu")
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    return p, tresnet.from_numpy(state, device="cpu")


def _grads(p, loss):
    return tresnet.to_numpy(tree_unflatten(p, torch.autograd.grad(loss, list(tree_leaves(p)))))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for name in sorted(tree) for k in _keys(tree[name], f"{prefix}/{name}")]
    return [prefix]


def _assert_trees_close(ref, got, tol, what):
    ref, got = _leaves(ref), _leaves(got)
    assert ref.keys() == got.keys()
    bad = {k: _rel(ref[k], got[k]) for k in ref if not _rel(ref[k], got[k]) <= tol}
    assert not bad, f"{what}: {bad}"


# ------------------------------------------------------------- padding --


@pytest.mark.parametrize("size", [31, 32])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_same_conv_padding_matches_lax(k, stride, size):
    """XLA pads SAME with the odd pad at the end: (2, 3) for 7x7/2 on an
    even size, which torch's symmetric padding=3 shifts by one."""
    rs = np.random.RandomState(k * 100 + stride * 10 + size)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    w = rs.randn(k, k, 3, 4).astype(np.float32)
    want = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tresnet.conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                            tresnet.from_numpy(w, device="cpu"), stride)
    assert tuple(got.shape) == (2, 4) + want.shape[1:3]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)
    assert tresnet.same_pads(size, k, stride) == jax.lax.padtype_to_pads(
        (size,), (k,), (stride,), "SAME")[0]


@pytest.mark.parametrize("size", [31, 32])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_max_pool_padding_matches_reduce_window(stride, size):
    x = np.random.RandomState(size + stride).randn(2, size, size, 5).astype(np.float32)
    want = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, stride, stride, 1), "SAME")
    got = tresnet.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ----------------------------------------------------------- the model --


def test_inference_logits_and_grads_match_jax(weights):
    params, state = weights
    x = _images(2, 32)
    y = np.array([3, 7], np.int32)

    def jloss(p):
        logits, _ = jresnet.apply(p, state, jnp.asarray(x), JCFG, training=False)
        return jce(logits, jnp.asarray(y)), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    p, s = _port(params, state)
    logits, new_s = tresnet.apply(p, s, torch.from_numpy(x), TCFG, training=False)
    # inference mode hands the running statistics back as they were
    assert all(a is b for a, b in zip(tree_leaves(new_s), tree_leaves(s)))
    assert _rel(jlogits, logits.detach()) <= 1e-4
    _assert_trees_close(jgrads, _grads(p, tce(logits, torch.from_numpy(y))), 2e-4, "grads")


def test_training_bottlenecks_match_jax_block_by_block(weights, monkeypatch):
    """Each block's input is captured from one training-mode forward of
    the port; both packages' blocks then run on it with one cotangent."""
    params, state = weights
    p, s = _port(params, state)
    inputs = []
    block = tresnet._bottleneck

    def capture(x, bp, bs, stride, *rest):
        inputs.append((x.detach().clone(), stride))
        return block(x, bp, bs, stride, *rest)

    monkeypatch.setattr(tresnet, "_bottleneck", capture)
    tresnet.apply(p, s, torch.from_numpy(_images(4, 64)), TCFG, training=True)
    names = [f"stage{i}_block{b}" for i, n in enumerate(jresnet.STAGES) for b in range(n)]
    assert len(inputs) == len(names) == 16
    rs = np.random.RandomState(2)
    for name, (x, stride) in zip(names, inputs):
        def jblock(xx, bp, name=name, stride=stride):
            return jresnet._bottleneck(xx, bp, state[name], stride, True, 0.9, 1e-5)

        xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
        (jout, jstate), vjp = jax.vjp(jblock, xj, params[name])
        # No cotangent where the output sits at the ReLU's kink, where a
        # last-bit difference takes the other branch (the gradient there
        # is 0 in both packages either way).
        ct = rs.randn(*jout.shape).astype(np.float32) * (np.asarray(jout) > 1e-4)
        jdx, jdp = vjp((jnp.asarray(ct), jax.tree.map(jnp.zeros_like, jstate)))
        xt = x.clone().requires_grad_(True)
        out, tstate = block(xt, p[name], s[name], stride, True, 0.9, 1e-5)
        leaves = [xt] + list(tree_leaves(p[name]))
        g = torch.autograd.grad(out, leaves, torch.from_numpy(ct).permute(0, 3, 1, 2))
        assert _rel(jout, out.detach().permute(0, 2, 3, 1)) <= 1e-4, name
        _assert_trees_close(jstate, tresnet.to_numpy(tstate), 1e-4, f"{name} state")
        assert _rel(jdx, g[0].permute(0, 2, 3, 1)) <= 2e-4, name
        _assert_trees_close(jdp, tresnet.to_numpy(tree_unflatten(p[name], g[1:])), 2e-4,
                            f"{name} grads")


def test_training_forward_matches_jax_whole_net(weights):
    params, state = weights
    x = _images(4, 64, seed=3)
    jlogits, jstate = jax.jit(lambda p, s: jresnet.apply(
        p, s, jnp.asarray(x), JCFG, training=True))(params, state)
    p, s = _port(params, state)
    logits, new_s = tresnet.apply(p, s, torch.from_numpy(x), TCFG, training=True)
    assert _rel(jlogits, logits.detach()) <= 2e-3
    _assert_trees_close(jstate, tresnet.to_numpy(new_s), 1e-3, "BN state")
    assert all(not t.requires_grad for t in tree_leaves(new_s))
    # the input state is untouched: apply is functional
    _assert_trees_close(state, tresnet.to_numpy(s), 0.0, "input state")


class _JnpF64:
    """``jax.numpy`` with ``float32`` read as ``float64``: put in place of
    the JAX modules' ``jnp``, it turns their f32 casts into f64 ones."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_whole_net_training_gradients_are_as_near_f64_as_jax(weights, monkeypatch):
    """Whole-net training-mode gradients are not held to JAX's f32 ones (see
    the module docstring). The truth is JAX's f64 evaluation of the same
    net (x64 on, every f32 cast made an f64 one). The port's own f64
    evaluation (``Tensor.float`` made ``double``) must equal it within
    F64_TOL of each leaf; the port's f32 gradients must then lie within
    twice JAX's f32 error of it (the error of a leaf: its relative L2
    distance from the truth; the worst leaf counts)."""
    params, state = weights
    x = _images(4, 64, seed=7)
    y = np.array([1, 4, 9, 0], np.int32)

    def jax_grads(dtype):
        cfg = dataclasses.replace(JCFG, dtype=dtype)
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)  # noqa: E731

        def jloss(p):
            logits, _ = jresnet.apply(p, cast(state), jnp.asarray(x, dtype), cfg, training=True)
            return jce(logits, jnp.asarray(y))

        return jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(cast(params)))

    def port_grads(dtype):
        p = tresnet.from_numpy(params, device="cpu", dtype=dtype)
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
        cfg = dataclasses.replace(TCFG, dtype=dtype)
        logits, _ = tresnet.apply(p, tresnet.from_numpy(state, device="cpu", dtype=dtype),
                                  torch.from_numpy(x).to(dtype), cfg, training=True)
        return _grads(p, tce(logits, torch.from_numpy(y)))

    jgrads, got = jax_grads(jnp.float32), port_grads(torch.float32)
    x64 = jax.config.jax_enable_x64
    with monkeypatch.context() as m:
        m.setattr(jresnet, "jnp", _JnpF64())
        m.setattr(jlosses, "jnp", _JnpF64())
        m.setattr(torch.Tensor, "float", torch.Tensor.double)
        jax.config.update("jax_enable_x64", True)
        try:
            truth = jax_grads(jnp.float64)
        finally:
            jax.config.update("jax_enable_x64", x64)
        port64 = port_grads(torch.float64)
    t = _leaves(truth)
    assert all(v.dtype == np.float64 for v in t.values())

    def err(grads):
        g = _leaves(grads)
        return max(float(np.linalg.norm(g[k].astype(np.float64) - t[k]) / np.linalg.norm(t[k]))
                   for k in t)

    assert err(port64) <= F64_TOL, err(port64)
    assert err(got) <= 2 * err(jgrads), (err(got), err(jgrads))


def test_s2d_stem_matches_jax_and_the_plain_stem(weights):
    params, state = weights
    x = _images(2, 32, seed=4)
    jcfg = dataclasses.replace(JCFG, stem_s2d=True)
    tcfg = dataclasses.replace(TCFG, stem_s2d=True)
    want, _ = jax.jit(lambda p: jresnet.apply(p, state, jnp.asarray(x), jcfg))(params)
    p, s = _port(params, state)
    with torch.no_grad():
        got, _ = tresnet.apply(p, s, torch.from_numpy(x), tcfg)
        plain, _ = tresnet.apply(p, s, torch.from_numpy(x), TCFG)
    assert _rel(want, got) <= 1e-4
    assert _rel(plain, got) <= 1e-4


@pytest.mark.parametrize("training", [False, True])
def test_uint8_images_equal_float_over_255(weights, training):
    params, state = weights
    u8 = np.random.RandomState(5).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    p, s = _port(params, state)
    with torch.no_grad():
        a, sa = tresnet.apply(p, s, torch.from_numpy(u8), TCFG, training=training)
        b, sb = tresnet.apply(p, s, torch.from_numpy(u8.astype(np.float32) / 255.0), TCFG,
                              training=training)
    assert torch.equal(a, b)
    _assert_trees_close(tresnet.to_numpy(sa), tresnet.to_numpy(sb), 0.0, "state")


# ------------------------------------------------- trees and carry-across --


def test_to_numpy_of_from_numpy_is_byte_identical():
    """bf16 (the default dtype) kernels cross HWIO -> OIHW channels_last ->
    HWIO with every bit kept."""
    cfg = jresnet.Config(num_classes=10)
    shapes = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), cfg))[0]
    rs = np.random.RandomState(6)
    tree = jax.tree.map(lambda sd: rs.randint(0, 1 << 16, sd.shape).astype(np.uint16)
                        if sd.dtype == jnp.bfloat16 else rs.randn(*sd.shape).astype(sd.dtype),
                        shapes)
    p = tresnet.from_numpy(tree, device="cpu")
    assert p["stem"].dtype == torch.bfloat16 and p["stem"].shape == (64, 3, 7, 7)
    assert p["stem"].is_contiguous(memory_format=torch.channels_last)
    back = tresnet.to_numpy(p)
    flat, got = _leaves(tree), _leaves(back)
    assert flat.keys() == got.keys()
    for k in flat:
        assert got[k].dtype == flat[k].dtype and got[k].shape == flat[k].shape, k
        assert got[k].tobytes() == flat[k].tobytes(), k


def test_init_tree_matches_jax():
    """Same keys, shapes (kernels transposed to OIHW), dtypes and count."""
    cfg = jresnet.Config()
    jp, js = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), cfg))
    tp, ts = tresnet.init(torch.Generator().manual_seed(0), tresnet.Config(), device="cpu")
    assert _keys(jp) == _keys(tp) and _keys(js) == _keys(ts)
    for (k, sd), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0], tree_leaves(tp)):
        want = sd.shape if len(sd.shape) != 4 else (sd.shape[3], sd.shape[2]) + sd.shape[:2]
        assert tuple(t.shape) == want, k
        assert str(t.dtype).removeprefix("torch.") == str(sd.dtype), k
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == tresnet.num_params() == sum(int(np.prod(sd.shape)) for sd in jax.tree.leaves(jp))
    assert 25.5e6 < n < 25.6e6
    assert tresnet.num_flops_per_image(112) == jresnet.num_flops_per_image(112)


def test_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tresnet.init(torch.Generator())


def test_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jresnet.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tresnet.Config)}
    assert jf.keys() == tf.keys()
    assert {k: v for k, v in jf.items() if k != "dtype"} == \
        {k: v for k, v in tf.items() if k != "dtype"}
