"""The port's parallel package (oim_tpu_torch.parallel) held against the
JAX package's (oim_tpu.parallel), on the CPU.

The copies (mesh-spec grammar, axis filling, size errors, registry
topology, the rules tables, the zigzag layout and schedule, MeshCoord,
REGISTRY_MESH, llama's logical axes) are compared directly. The
collectives and the sequence-parallel attentions run on 2 and 4 gloo
ranks (``tests/torch_parallel_worker.py``, one job per world size, each
rank a process that imports the port only); JAX runs the same functions
under shard_map on the fake CPU devices of tests/conftest.py, on the same
numpy inputs and cotangents. Tolerances (f32): 2e-5 forward, 2e-4
backward, as tests/test_ops.py holds the attention kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from oim_tpu.common import meshcoord as jmeshcoord
from oim_tpu.common import pathutil as jpathutil
from oim_tpu.models import llama as jllama
from oim_tpu.parallel import collectives as jcoll
from oim_tpu.parallel import mesh as jmesh
from oim_tpu.parallel import ring as jring
from oim_tpu.parallel import sharding as jsharding
from oim_tpu.parallel.compat import shard_map
from oim_tpu_torch.common import meshcoord as tmeshcoord
from oim_tpu_torch.common import pathutil as tpathutil
from oim_tpu_torch.models import llama as tllama
from oim_tpu_torch.parallel import collectives as tcoll
from oim_tpu_torch.parallel import mesh as tmesh
from oim_tpu_torch.parallel import ring as tring
from oim_tpu_torch.parallel import sharding as tsharding
from tests.torch_parallel_worker import Job

FWD_TOL, BWD_TOL = 2e-5, 2e-4
WORLDS = (2, 4)
OPS = ("psum", "pmean", "all_gather", "all_gather_untiled", "reduce_scatter",
       "all_to_all", "ppermute", "ppermute_back2")
# (kind, causal, kv heads) of 4 query heads: GQA groups 1, 2 and 4 causal,
# group 2 unmasked. Ulysses over 4 ranks with 2 or 1 kv heads (and over 2
# with 1) takes the expand fallback.
ATTN = [(kind, True, hkv) for kind in ("ring", "zigzag", "ulysses") for hkv in (4, 2, 1)] + [
    (kind, False, 2) for kind in ("ring", "zigzag", "ulysses")]
B, T, H, D = 2, 16, 4, 8
JOB_TIMEOUT = 300.0


# ------------------------------------------------------------ copies ----


@pytest.mark.parametrize("spec", ["", "data=4", "data=2,fsdp=2", " seq =8,model=1",
                                  "data", "data=", "data=x"])
def test_parse_axes_matches_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(tmesh.parse_axes) == outcome(jmesh.parse_axes)


@pytest.mark.parametrize("args", [(8,), (8, 0, 2), (8, 0, 1, 4), (8, 2, 2, 2), (6, 0, 4),
                                  (4, 0, 1, 1, 4)])
def test_default_axes_matches_jax(args):
    def outcome(fn):
        try:
            return fn(*args)
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(tmesh.default_axes) == outcome(jmesh.default_axes)


def test_size_errors_match_jax():
    for axes, n in (([("data", 4)], 2), ([("data", 2), ("seq", 2)], 3)):
        with pytest.raises(ValueError) as jerr:
            jmesh._check_sizes(axes, n)
        with pytest.raises(ValueError) as terr:
            tmesh._check_sizes(axes, n)
        assert str(terr.value) == str(jerr.value)
    # One process without torch.distributed is a world of one rank.
    with pytest.raises(ValueError, match="require 2 devices, have 1"):
        tmesh.build_mesh([("data", 2)], device="cpu")


def test_topology_from_registry_matches_jax():
    entries = {"c0/mesh": "0,0,0", "c0/address": "h:1", "c1/mesh": "1,*,0,1",
               "c2/mesh": "", "c3/other": "1,1,1", "deep/c4/mesh": "2,2,2",
               "serve/x": "{}"}
    got = {k: v.format() for k, v in tmesh.topology_from_registry(entries).items()}
    want = {k: v.format() for k, v in jmesh.topology_from_registry(entries).items()}
    assert got == want and set(got) == {"c0", "c1", "c2"}


def test_registry_mesh_constant_matches():
    assert tpathutil.REGISTRY_MESH == jpathutil.REGISTRY_MESH


@pytest.mark.parametrize("s", ["", "1,2,3", "1,*,3,0", " 4 , 5 ,6", "*,*,*", "1,2",
                               "1,2,3,4,5", "1,-1,2", "a,b,c"])
def test_meshcoord_copy_matches(s):
    def outcome(mod):
        try:
            c = mod.MeshCoord.parse(s)
        except ValueError as e:
            return f"ValueError: {e}"
        full = c.complete(mod.MeshCoord(7, 8, 9, 1))
        return (c.x, c.y, c.z, c.core, c.format(), c.is_complete(),
                (full.x, full.y, full.z, full.core), full.is_complete())

    assert outcome(tmeshcoord) == outcome(jmeshcoord)


def test_rules_tables_and_names_match_jax():
    for name in ("DP_RULES", "FSDP_RULES", "TP_SP_RULES", "PIPE_RULES"):
        assert getattr(tsharding, name).rules == getattr(jsharding, name).rules, name
    for name in ("BATCH", "SEQ", "EMBED", "HEAD", "KV_HEAD", "HEAD_DIM", "MLP", "VOCAB",
                 "EXPERT", "CONV_IN", "CONV_OUT", "LAYER"):
        assert getattr(tsharding, name) == getattr(jsharding, name), name
    logical = (tsharding.BATCH, tsharding.EMBED, None, tsharding.HEAD)
    for name in ("DP_RULES", "FSDP_RULES", "TP_SP_RULES", "PIPE_RULES"):
        want = tuple(getattr(jsharding, name).spec(logical))
        assert getattr(tsharding, name).spec(logical) == want


def test_llama_logical_axes_match_jax():
    cfg = tllama.tiny()
    assert tllama.param_logical_axes(cfg) == jllama.param_logical_axes(jllama.tiny())
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        tllama.param_logical_axes(tllama.tiny(n_experts=4))


@pytest.mark.parametrize("n", range(1, 9))
def test_zigzag_layout_and_schedule_match_jax(n):
    for seq in (2 * n, 6 * n):
        np.testing.assert_array_equal(tring.zigzag_permutation(seq, n),
                                      jring.zigzag_permutation(seq, n))
        np.testing.assert_array_equal(
            np.concatenate([tring.shard_positions(seq, n, i, "zigzag") for i in range(n)]),
            jring.zigzag_permutation(seq, n))
    assert tring.zigzag_schedule(n) == jring.zigzag_schedule(n)
    with pytest.raises(ValueError, match="not divisible"):
        tring.zigzag_permutation(2 * n + 1, n)


def test_sharding_cuts_and_names_missing_axes():
    mesh = tmesh.Mesh([("data", 1), ("fsdp", 1)], [0], "cpu")
    s = tsharding.logical_sharding(mesh, tsharding.FSDP_RULES,
                                   (tsharding.LAYER, tsharding.EMBED, tsharding.HEAD))
    assert s.dims == ((), ("fsdp",), ()) and s.axes == ("fsdp",)
    x = np.arange(24).reshape(2, 3, 4)
    assert s.shard(x, mesh) is x
    with pytest.raises(ValueError, match="Resource axis: seq"):
        tsharding.logical_sharding(mesh, tsharding.TP_SP_RULES, (tsharding.SEQ,))
    # A mesh without torch.distributed: collectives are the identity.
    t = torch.arange(4.0)
    assert tcoll.psum(t, mesh.axis("data")).equal(t)
    assert tcoll.all_gather(t, mesh.axis("fsdp")).equal(t)


def test_merge_of_masked_blocks_is_nan_free():
    """A block every query of which is masked contributes o = 0 and
    lse = NEG_INF, finite: merging it, even into an empty accumulator,
    gives finite values and gradients, as the JAX merge does."""
    o = torch.zeros(1, 3, 2, 4, requires_grad=True)
    lse = torch.full((1, 3, 2), tring.NEG_INF, requires_grad=True)
    o_blk = torch.randn(1, 3, 2, 4, requires_grad=True)
    lse_blk = torch.full((1, 3, 2), tring.NEG_INF, requires_grad=True)
    out, lse_new = tring._merge(o, lse, o_blk, lse_blk)
    (out.sum() + lse_new.sum()).backward()
    jo, jl = jring._merge(*(jnp.asarray(x.detach().numpy()) for x in (o, lse, o_blk, lse_blk)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), atol=FWD_TOL)
    np.testing.assert_allclose(lse_new.detach().numpy(), np.asarray(jl), rtol=1e-6)
    for t in (o, lse, o_blk, lse_blk):
        assert torch.isfinite(t.grad).all()


def test_refusals_match_jax():
    """Zigzag with an odd local length and Ulysses with heads the axis does
    not divide raise in both packages (before any communication)."""
    axis = tmesh.Axis(name="seq", size=2, index=0, ranks=(0, 1))
    q = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError, match="odd"):
        tring.zigzag_ring_attention(q, q, q, axis)
    q3 = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="divisible"):
        tring.ulysses_attention(q3, q3, q3, axis)
    with pytest.raises(ValueError, match="unknown sequence-parallel kind"):
        tring.make_sequence_parallel_attention(None, kind="tree")
    # A global length that 2 x the axis does not divide: JAX refuses it when
    # it permutes into the zigzag layout, the port when it cuts a shard.
    with pytest.raises(ValueError, match="not divisible"):
        tring.shard_positions(6, 2, 0, "zigzag")
    mesh = jmesh.build_mesh([("data", 1), ("seq", 2)], jax.devices()[:2])
    with pytest.raises(ValueError, match="not divisible"):
        jax.eval_shape(jring.make_sequence_parallel_attention(mesh, "zigzag"),
                       *(jnp.zeros((1, 6, 4, 8)),) * 3)
    with pytest.raises(ValueError, match="divisible"):
        jax.eval_shape(jring.make_sequence_parallel_attention(mesh, "ulysses"),
                       *(jnp.zeros((1, 4, 3, 8)),) * 3)


# ---------------------------------------------- multi-rank, gloo jobs ----


def _jax_collective(op, n, axes, x, c):
    mesh = jmesh.build_mesh(axes, jax.devices()[:n])
    names = tuple(a for a, _ in axes)
    ax = names if len(names) > 1 else names[0]
    fn = {
        "psum": lambda x: jcoll.psum(x, ax),
        "pmean": lambda x: jcoll.pmean(x, ax),
        "all_gather": lambda x: jcoll.all_gather(x, ax, gather_dim=1),
        "all_gather_untiled": lambda x: jcoll.all_gather(x, ax, tiled=False, gather_dim=1),
        "reduce_scatter": lambda x: jcoll.reduce_scatter(x, ax, scatter_dim=1),
        "all_to_all": lambda x: jcoll.all_to_all(x, ax, split_dim=1, concat_dim=0),
        "ppermute": lambda x: jcoll.ppermute_ring(x, ax),
        "ppermute_back2": lambda x: jcoll.ppermute_ring(x, ax, shift=-2),
    }[op]
    sm = shard_map(fn, mesh=mesh, in_specs=P(names), out_specs=P(names), check_vma=False)
    if c is None:
        return jax.eval_shape(sm, x).shape
    y, vjp = jax.vjp(sm, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(c))[0])


def _collective_scenario(name, n, axes, ops, rng, inputs, refs):
    x = rng.randn(2 * n, 4 * n).astype(np.float32)
    inputs[f"{name}/x"] = x
    for op in ops:
        c = rng.randn(*_jax_collective(op, n, axes, x, None)).astype(np.float32)
        inputs[f"{name}/c_{op}"] = c
        refs[(name, op)] = (x, c)
    return {"type": "collectives", "name": name, "axes": axes, "ops": list(ops)}


def _attn_name(kind, causal, hkv):
    return f"attn_{kind}_{'causal' if causal else 'full'}_kv{hkv}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' jobs started together; JAX computes the references
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("parallel")
    jobs, refs, specs = {}, {}, {}
    for n in WORLDS:
        rng = np.random.RandomState(n)
        inputs, scenarios, ref = {}, [], {}
        scenarios.append(_collective_scenario("coll", n, [("x", n)], OPS, rng, inputs, ref))
        if n == 4:
            scenarios.append(_collective_scenario("coll2d", n, [("a", 2), ("b", 2)],
                                                  ("psum", "pmean"), rng, inputs, ref))
        for kind, causal, hkv in ATTN:
            name = _attn_name(kind, causal, hkv)
            for x, heads in (("q", H), ("k", hkv), ("v", hkv), ("g", H)):
                inputs[f"{name}/{x}"] = rng.randn(B, T, heads, D).astype(np.float32)
            scenarios.append({"type": "attention", "name": name, "kind": kind,
                              "causal": causal})
        jobs[n] = Job(tmp, n, inputs, scenarios, JOB_TIMEOUT)
        refs[n], specs[n] = ref, inputs
    want = {}
    for n in WORLDS:
        for (name, op), (x, c) in refs[n].items():
            axes = [("x", n)] if name == "coll" else [("a", 2), ("b", 2)]
            want[(n, name, op)] = _jax_collective(op, n, axes, x, c)
        mesh = jmesh.build_mesh([("data", 1), ("seq", n)], jax.devices()[:n])
        for kind, causal, hkv in ATTN:
            name = _attn_name(kind, causal, hkv)
            fn = jring.make_sequence_parallel_attention(mesh, kind=kind, causal=causal)

            def both(q, k, v, g, fn=fn):
                out, vjp = jax.vjp(fn, q, k, v)
                return out, vjp(g)

            args = [jnp.asarray(specs[n][f"{name}/{x}"]) for x in "qkvg"]
            out, grads = jax.jit(both)(*args)
            want[(n, name)] = (np.asarray(out), [np.asarray(g) for g in grads])
    got = {n: jobs[n].results() for n in WORLDS}
    return got, want


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("op", OPS)
def test_collective_and_its_backward_match_jax(runs, n, op):
    got, want = runs
    y, dx = want[(n, "coll", op)]
    np.testing.assert_allclose(np.concatenate([r[f"coll/{op}/y"] for r in got[n]]), y,
                               atol=FWD_TOL)
    np.testing.assert_allclose(np.concatenate([r[f"coll/{op}/dx"] for r in got[n]]), dx,
                               atol=FWD_TOL)


@pytest.mark.parametrize("op", ("psum", "pmean"))
def test_reduction_over_two_axes_matches_jax(runs, op):
    got, want = runs
    y, dx = want[(4, "coll2d", op)]
    np.testing.assert_allclose(np.concatenate([r[f"coll2d/{op}/y"] for r in got[4]]), y,
                               atol=FWD_TOL)
    np.testing.assert_allclose(np.concatenate([r[f"coll2d/{op}/dx"] for r in got[4]]), dx,
                               atol=FWD_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_axis_index_size_and_no_staging_on_the_cpu(runs, n):
    got, _ = runs
    for rank, r in enumerate(got[n]):
        assert r["coll/index"].tolist() == [rank] and r["coll/size"].tolist() == [n]
        # gloo takes every CPU tensor itself: nothing goes through host buffers.
        assert int(r["staged_calls"]) == 0
    if n == 4:
        assert [r["coll2d/index"].tolist() for r in got[4]] == [[0, 0], [0, 1], [1, 0], [1, 1]]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind,causal,hkv", ATTN)
def test_sequence_parallel_attention_matches_jax(runs, n, kind, causal, hkv):
    """Output and q/k/v gradients of each rank's shards, put back in
    sequence order, against JAX's make_sequence_parallel_attention."""
    got, want = runs
    name = _attn_name(kind, causal, hkv)
    out_w, grads_w = want[(n, name)]
    full = {x: np.zeros_like(w) for x, w in zip(("out", "dq", "dk", "dv"), [out_w, *grads_w])}
    for r in got[n]:
        for x in full:
            full[x][:, r[f"{name}/pos"]] = r[f"{name}/{x}"]
    np.testing.assert_allclose(full["out"], out_w, atol=FWD_TOL)
    for x, w in zip(("dq", "dk", "dv"), grads_w):
        np.testing.assert_allclose(full[x], w, atol=BWD_TOL, err_msg=x)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", ("ring", "zigzag", "ulysses"))
def test_block_attentions_per_rank_follow_the_schedule(runs, n, kind):
    """K1's calls per rank (counted on the CPU as block attentions): the
    causal ring skips the blocks in its future (rank i runs i + 1), the
    zigzag ring runs one per step on every rank, Ulysses one."""
    got, _ = runs
    name = _attn_name(kind, True, 2)
    calls = [int(r[f"{name}/calls"]) for r in got[n]]
    want = {"ring": [i + 1 for i in range(n)], "zigzag": [n] * n, "ulysses": [1] * n}[kind]
    assert calls == want
    full = [int(r[f"{_attn_name(kind, False, 2)}/calls"]) for r in got[n]]
    assert full == ([1] * n if kind == "ulysses" else [n] * n)


def test_shard_params_and_batch_cut_this_ranks_pieces():
    """Rank 0's view of a 2 x 2 (data, fsdp) mesh: FSDP cuts each weight's
    embed dim in two and the batch's rows in four (data major); numpy and
    torch trees alike."""
    mesh = tmesh.Mesh([("data", 2), ("fsdp", 2)], [0, 1, 2, 3], "cpu")
    assert mesh.coordinate == (0, 0)
    cfg = tllama.tiny()
    logical = tllama.param_logical_axes(cfg)
    rng = np.random.RandomState(0)
    full = {"embed": rng.randn(cfg.vocab, cfg.dim), "final_norm": rng.randn(cfg.dim),
            "lm_head": torch.tensor(rng.randn(cfg.dim, cfg.vocab))}
    part = tsharding.shard_params(mesh, tsharding.FSDP_RULES, full,
                                  {k: logical[k] for k in full})
    np.testing.assert_array_equal(part["embed"], full["embed"][:, :cfg.dim // 2])
    assert part["final_norm"] is full["final_norm"]
    assert torch.equal(part["lm_head"], full["lm_head"][:cfg.dim // 2])
    batch = {"tokens": np.arange(8 * 5).reshape(8, 5)}
    rows = tsharding.shard_batch(mesh, tsharding.FSDP_RULES, batch)["tokens"]
    np.testing.assert_array_equal(rows, batch["tokens"][:2])
    dp_rows = tsharding.shard_batch(mesh, tsharding.DP_RULES, batch)["tokens"]
    np.testing.assert_array_equal(dp_rows, batch["tokens"][:4])
    with pytest.raises(ValueError, match="does not divide"):
        tsharding.shard_batch(mesh, tsharding.FSDP_RULES, {"tokens": np.zeros((6, 5))})
