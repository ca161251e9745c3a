"""The port's tensor-parallel pieces on 2 gloo ranks
(``tests/torch_parallel_worker.py``), on the CPU, in f32:

* ``copy_to``/``reduce_from`` around a Megatron MLP (a column-split
  product, SiLU, a row-split product): output and gradients against the
  unsharded product, and one psum each way (``reduce_from`` forward,
  ``copy_to`` backward); the plain ``psum`` in ``reduce_from``'s place
  doubles x's gradient.
* ``vocab_parallel_cross_entropy`` with ``ignore_index`` and ``z_loss``,
  whole-slice and chunked, "mean" and "sum": value, z-loss term and
  gradients against JAX's under shard_map on the fake CPU devices of
  tests/conftest.py and against the unsharded CE, with one pmax and two
  psums in the forward.

Tolerances: value 2e-5, gradients 2e-4 (tests/test_ops.py's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

from oim_tpu.ops.losses import vocab_parallel_cross_entropy as jvce
from oim_tpu.parallel.compat import shard_map
from oim_tpu_torch.ops.losses import softmax_cross_entropy
from oim_tpu_torch.parallel import collectives as C
from oim_tpu_torch.parallel.mesh import Mesh as TMesh
from tests.torch_parallel_worker import Job

FWD_TOL, BWD_TOL = 2e-5, 2e-4
WORLD = 2
N, D, V, K, HID = 12, 16, 40, 8, 12
# (vocab_chunk, z_loss, reduction) of the vocab-parallel CE cases.
CE_CASES = [(0, 0.0, "mean"), (0, 1e-3, "mean"), (8, 1e-3, "mean"), (6, 0.0, "sum"),
            (0, 1e-2, "sum")]
JOB_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(5)
    inputs = {
        "mlp/x": rng.randn(N, K).astype(np.float32),
        "mlp/w": (rng.randn(K, HID) * 0.5).astype(np.float32),
        "mlp/v": (rng.randn(HID, K) * 0.5).astype(np.float32),
        "mlp/g": rng.randn(N, K).astype(np.float32),
        "ce/y": rng.randn(N, D).astype(np.float32),
        "ce/w": (rng.randn(D, V) * 0.4).astype(np.float32),
    }
    labels = rng.randint(0, V, N).astype(np.int32)
    labels[[1, 4, 5]] = -1  # ignore_index
    labels[0], labels[2] = 0, V - 1  # the first and the last vocabulary id
    inputs["ce/labels"] = labels
    job = Job(tmp_path_factory.mktemp("tp"), WORLD, inputs,
              [{"type": "tp_ops", "name": "mlp"},
               {"type": "vocab_ce", "name": "ce", "cases": CE_CASES}], JOB_TIMEOUT)
    return inputs, job.results()


def _mlp(x, w, v):
    return F.silu(x @ w) @ v


def test_megatron_mlp_forward_and_gradients_match_the_unsharded_product(runs):
    inputs, ranks = runs
    x, w, v = (torch.tensor(inputs[f"mlp/{k}"], dtype=torch.float64).requires_grad_(True)
               for k in ("x", "w", "v"))
    y = _mlp(x, w, v)
    y.backward(torch.tensor(inputs["mlp/g"], dtype=torch.float64))
    cols = HID // WORLD
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["mlp/y"], y.detach().numpy(), atol=FWD_TOL)
        np.testing.assert_allclose(res["mlp/dx"], x.grad.numpy(), atol=BWD_TOL)
        np.testing.assert_allclose(res["mlp/dw"], w.grad.numpy()[:, r * cols:(r + 1) * cols],
                                   atol=BWD_TOL)
        np.testing.assert_allclose(res["mlp/dv"], v.grad.numpy()[r * cols:(r + 1) * cols],
                                   atol=BWD_TOL)
        assert int(res["mlp/calls"]) == 2  # reduce_from forward, copy_to backward


def test_plain_psum_in_place_of_reduce_from_scales_the_gradient(runs):
    """The trap the conjugate pair avoids: psum's own backward sums an
    already replicated cotangent, so a gradient below it is multiplied by
    the axis size."""
    _, ranks = runs
    for res in ranks:
        np.testing.assert_allclose(res["mlp/dx_plain_psum"], WORLD * res["mlp/dx"],
                                   rtol=1e-6, atol=1e-6)


def _jax_ce(y, w, labels, z_loss, reduction):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("model",))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P(None, "model"), P()),
                       out_specs=P(), check_vma=False)
    def fn(y, w, labels):
        return jvce(y, w, labels, "model", ignore_index=-1, reduction=reduction,
                    z_loss=z_loss)

    loss = jax.jit(fn)(y, w, labels)
    dy, dw = jax.grad(lambda a, b: fn(a, b, labels), argnums=(0, 1))(y, w)
    return float(loss), np.asarray(dy), np.asarray(dw)


@pytest.mark.parametrize("case", range(len(CE_CASES)))
def test_vocab_parallel_ce_matches_jax_and_the_unsharded_ce(runs, case):
    inputs, ranks = runs
    chunk, z_loss, reduction = CE_CASES[case]
    y_np, w_np, lab_np = inputs["ce/y"], inputs["ce/w"], inputs["ce/labels"]
    j_loss, j_dy, j_dw = _jax_ce(jnp.asarray(y_np), jnp.asarray(w_np), jnp.asarray(lab_np),
                                 z_loss, reduction)
    # The unsharded CE (the port's), in f64.
    y = torch.tensor(y_np, dtype=torch.float64).requires_grad_(True)
    w = torch.tensor(w_np, dtype=torch.float64).requires_grad_(True)
    labels = torch.tensor(lab_np).long()
    ref = softmax_cross_entropy(y @ w, labels, ignore_index=-1, z_loss=z_loss)
    kept = int((labels != -1).sum())
    if reduction == "sum":
        ref = ref * kept
    ref.backward()
    logz = torch.logsumexp(y.detach() @ w.detach(), -1)
    z_term = z_loss * float((logz.square() * (labels != -1)).sum()) / (
        1 if reduction == "sum" else kept)
    cols = V // WORLD
    np.testing.assert_allclose(j_loss, float(ref.detach()), atol=FWD_TOL, rtol=1e-6)
    for r, res in enumerate(ranks):
        got = res[f"ce/{case}/loss"]
        np.testing.assert_allclose(got, j_loss, atol=FWD_TOL, rtol=1e-6)
        np.testing.assert_allclose(got, float(ref.detach()), atol=FWD_TOL, rtol=1e-6)
        np.testing.assert_allclose(res[f"ce/{case}/z_term"], z_term, atol=FWD_TOL, rtol=1e-6)
        np.testing.assert_allclose(res[f"ce/{case}/dy"], j_dy, atol=BWD_TOL)
        np.testing.assert_allclose(res[f"ce/{case}/dy"], y.grad.numpy(), atol=BWD_TOL)
        np.testing.assert_allclose(res[f"ce/{case}/dw"], j_dw[:, r * cols:(r + 1) * cols],
                                   atol=BWD_TOL)
        np.testing.assert_allclose(res[f"ce/{case}/dw"],
                                   w.grad.numpy()[:, r * cols:(r + 1) * cols], atol=BWD_TOL)
        assert res[f"ce/{case}/fwd_calls"].tolist() == [1, 2]  # one pmax, two psums


def test_vocab_parallel_ce_on_one_process_is_the_unsharded_ce():
    from oim_tpu_torch.ops.losses import chunked_softmax_cross_entropy, \
        vocab_parallel_cross_entropy

    axis = TMesh([("model", 1)], [0], "cpu").axis("model")
    g = torch.Generator().manual_seed(2)
    y = torch.randn(2, 5, D, generator=g)
    w = torch.randn(D, V, generator=g) * 0.4
    labels = torch.randint(0, V, (2, 5), generator=g)
    labels[0, 0] = -1
    want = chunked_softmax_cross_entropy(y, w, labels, 16, ignore_index=-1, z_loss=1e-3,
                                         return_z_term=True, denom=torch.tensor(20.0))
    got = vocab_parallel_cross_entropy(y, w, labels, axis, -1, z_loss=1e-3, denom=torch.tensor(20.0),
                                       vocab_chunk=16, return_z_term=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=FWD_TOL, rtol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        vocab_parallel_cross_entropy(y, w, labels, axis, reduction="none")
