"""Pipeline parallelism in the port (``parallel/pipeline.py``,
``parallel/pipeline_1f1b.py``, ``llama.make_pipelined_loss`` /
``make_1f1b_loss`` and the trainer's rules "pipe") held against the JAX
package on the CPU.

The schedule: the port's copy of ``simulate_1f1b`` gives the JAX tables
array for array for P in 1..4, M in {P, 2P, 3P}, v in {1, 2}, and
``validate_schedule`` refuses the same corrupted schedules with the same
errors.

The executors, on gloo ranks (``tests/torch_parallel_worker.py``): GPipe
and 1F1B (v = 1 and 2) on a toy stage against JAX's ``pipeline_apply``
under ``jax.grad`` and its ``pipeline_1f1b_value_and_grad``; then the
port's Trainer against the JAX Trainer at the same mesh, llama-tiny (or
llama-tiny-moe), f32, 3 steps from the same initial params
(``from_numpy``): pipe=2 under GPipe, 1F1B and interleaved 1F1B (v=2, 4
layers); MoE under both schedules (and at data=2); accumulation with
1F1B; z-loss under both; remat under both; data=2,pipe=2 under both;
pipe=2,seq=2 with ring, zigzag and Ulysses under 1F1B and ring under
GPipe; an uneven ``ignore_index`` mask under 1F1B at data=2,pipe=2. A
checkpoint under pipe=2 resumes on the same mesh and on one process.

Tolerances as tests/test_torch_parallel_train.py's: per-step loss 1e-4
absolute, grad_norm 1e-4 relative, the gathered final params and eval
loss 2e-4, the MoE drop share 1e-6, replicas equal to the bit; the toy
executors 1e-5 (JAX's own 1F1B-against-GPipe tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oim_tpu.parallel import pipeline_1f1b as jp1
from oim_tpu.parallel.pipeline import make_pipelined_apply
from oim_tpu.train import trainer as jtrainer
from oim_tpu_torch.parallel import pipeline_1f1b as tp1
from oim_tpu_torch.parallel.mesh import Mesh
from oim_tpu_torch.train import trainer as ttrainer
from tests.test_torch_parallel_train import _flat, _uneven_tokens
from tests.torch_parallel_worker import Job

STEPS = 3
JOB_TIMEOUT = 300.0
COMMON = dict(lr=1e-2, warmup_steps=2, total_steps=10, log_every=1, seed=3)
P2 = [("data", 1), ("pipe", 2)]
DP2 = [("data", 2), ("pipe", 2)]
SEQ2 = [("data", 1), ("pipe", 2), ("seq", 2)]
TINY, MOE = dict(model="llama-tiny"), dict(model="llama-tiny-moe")
ONE_F = dict(pipeline_schedule="1f1b")
BT = dict(batch_size=4, seq_len=16)
# name -> (world, axes, config beyond COMMON, uneven ignore_index mask)
SCENARIOS = {
    "gpipe": (2, P2, dict(**TINY, **BT), False),
    "1f1b": (2, P2, dict(**TINY, **BT, **ONE_F), False),
    "1f1b_v2": (2, P2, dict(**TINY, **BT, **ONE_F, virtual_stages=2,
                            model_overrides={"n_layers": 4}), False),
    "gpipe_moe": (2, P2, dict(**MOE, **BT, microbatches=2), False),
    "1f1b_moe": (2, P2, dict(**MOE, **BT, **ONE_F, microbatches=2), False),
    "1f1b_accum": (2, P2, dict(**TINY, batch_size=8, seq_len=16, **ONE_F, microbatches=2,
                               accum_steps=2), False),
    "gpipe_zloss": (2, P2, dict(**TINY, **BT, model_overrides={"z_loss": 1e-3}), False),
    "1f1b_zloss": (2, P2, dict(**TINY, **BT, **ONE_F, model_overrides={"z_loss": 1e-3}),
                   False),
    "gpipe_remat": (2, P2, dict(**TINY, **BT, remat=True), False),
    "1f1b_remat": (2, P2, dict(**TINY, **BT, **ONE_F, remat=True), False),
    "dp2_gpipe": (4, DP2, dict(**TINY, **BT, microbatches=2), False),
    "dp2_1f1b": (4, DP2, dict(**TINY, **BT, **ONE_F, microbatches=2), False),
    "dp2_moe_gpipe": (4, DP2, dict(**MOE, **BT, microbatches=2), False),
    "seq_ring_1f1b": (4, SEQ2, dict(**TINY, batch_size=2, seq_len=16, **ONE_F,
                                    microbatches=2, seq_parallel="ring"), False),
    "seq_zigzag_1f1b": (4, SEQ2, dict(**TINY, batch_size=2, seq_len=16, **ONE_F,
                                      microbatches=2, seq_parallel="zigzag"), False),
    "seq_ulysses_1f1b": (4, SEQ2, dict(**TINY, batch_size=2, seq_len=16, **ONE_F,
                                       microbatches=2, seq_parallel="ulysses"), False),
    "seq_ring_gpipe": (4, SEQ2, dict(**TINY, batch_size=2, seq_len=16, microbatches=2,
                                     seq_parallel="ring"), False),
    "uneven_1f1b": (4, DP2, dict(**TINY, **BT, **ONE_F, microbatches=2), True),
}
# Faults planted in the worker's run of a scenario (fault -> scenario),
# which the limits must catch: the head's psum over the vocab split
# forgotten in its backward (what JAX's verify_sharded_head_contract
# guards), interleaving on the canonical layer order.
FAULTS = {"head_unsummed": "1f1b", "canonical_order": "1f1b_v2"}
# The checkpoint cell: 1F1B under pipe=2, saved at step 2 and resumed.
CKPT = dict(**TINY, **BT, **ONE_F, rules="pipe", **COMMON)
# The toy executors: name -> (world, schedule, v, layers, microbatches).
TOYS = {
    "toy_gpipe": (2, "gpipe", 1, 4, 4),
    "toy_1f1b": (2, "1f1b", 1, 4, 4),
    "toy_1f1b_v2": (2, "1f1b", 2, 4, 4),
    "toy_gpipe_p4": (4, "gpipe", 1, 8, 4),
    "toy_1f1b_p4": (4, "1f1b", 1, 8, 8),
    "toy_1f1b_p4_v2": (4, "1f1b", 2, 8, 8),
}
TOY_D, TOY_MB = 8, 2


def _jcfg(name):
    return jtrainer.TrainConfig(rules="pipe", **COMMON, **SCENARIOS[name][2])


def _jax_steps(tr, tokens, eval_tokens):
    data = (iter({"tokens": t} for t in tokens) if tokens is not None
            else jtrainer.synthetic_batches(tr.cfg))
    losses, norms, drops, zterms = [], [], [], []
    for _ in range(STEPS):
        tr.state, stats = tr.step_fn(tr.state, tr.place_batch(next(data)))
        losses.append(float(stats["loss"]))
        norms.append(float(stats["grad_norm"]))
        drops.append(float(stats.get("moe_drop_frac", np.nan)))
        zterms.append(float(stats.get("z_loss_term", np.nan)))
    final = _flat(jax.tree.map(np.asarray, tr.state.params))
    eval_loss = tr.evaluate(iter([{"tokens": eval_tokens}]), 1)
    return {"losses": losses, "norms": norms, "drops": drops, "zterms": zterms,
            "final": final, "eval": eval_loss, "eval_stats": dict(tr.last_eval_stats)}


def _toy_inputs(name, seed):
    world, _, _, n_layers, m = TOYS[name]
    rng = np.random.default_rng(seed)
    d = TOY_D
    return {
        f"{name}/w": (rng.standard_normal((n_layers, d, d)) * 0.3).astype(np.float32),
        f"{name}/b": (rng.standard_normal((n_layers, d)) * 0.1).astype(np.float32),
        f"{name}/wo": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
        f"{name}/x": rng.standard_normal((m, TOY_MB, d)).astype(np.float32),
        f"{name}/tgt": rng.standard_normal((m, TOY_MB, d)).astype(np.float32),
    }


def _toy_jax(name, inputs):
    """JAX's own executor on the toy: (loss, dw, db, dwo, dx)."""
    world, schedule, v, _, m = TOYS[name]
    from jax.sharding import Mesh as JMesh

    mesh = JMesh(np.array(jax.devices()[:world]).reshape(world, 1), ("pipe", "data"))
    stacked = {"w": jnp.asarray(inputs[f"{name}/w"]), "b": jnp.asarray(inputs[f"{name}/b"])}
    head = {"wo": jnp.asarray(inputs[f"{name}/wo"])}
    x, tgt = jnp.asarray(inputs[f"{name}/x"]), jnp.asarray(inputs[f"{name}/tgt"])

    def layer_fn(h, layer):
        return jnp.tanh(h @ layer["w"] + layer["b"])

    def head_loss(h, hp, t):
        return jnp.mean((h @ hp["wo"] - t) ** 2)

    if schedule == "1f1b":
        vg = jp1.make_1f1b_value_and_grad(mesh, layer_fn, head_loss, n_microbatches=m,
                                          n_virtual=v)
        loss, d_st, d_hd, d_x = jax.jit(vg)(stacked, head, x, tgt)
    else:
        apply = make_pipelined_apply(mesh, layer_fn, n_microbatches=m, axis="pipe")

        def gpipe_loss(st, hd, xx):
            outs = apply(st, xx)
            return sum(head_loss(outs[j], hd, tgt[j]) for j in range(m)) / m

        loss, (d_st, d_hd, d_x) = jax.jit(
            jax.value_and_grad(gpipe_loss, argnums=(0, 1, 2)))(stacked, head, x)
    return {"loss": float(loss), "dw": np.asarray(d_st["w"]), "db": np.asarray(d_st["b"]),
            "dwo": np.asarray(d_hd["wo"]), "dx": np.asarray(d_x)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.RandomState(13)
    trainers, inputs, batches, evals = {}, {2: {}, 4: {}}, {}, {}
    scenarios = {2: [], 4: []}
    for name, (world, axes, extra, uneven) in SCENARIOS.items():
        tr = jtrainer.Trainer(_jcfg(name), axes=axes)
        tr.init_or_resume()
        trainers[name] = tr
        for k, v in _flat(jax.tree.map(np.asarray, tr.state.params)).items():
            inputs[world][f"{name}/params/{k}"] = v
        vocab, b, t = tr.cfg.model_config().vocab, extra["batch_size"], extra["seq_len"]
        batches[name] = _uneven_tokens(rng, vocab, STEPS, b, t) if uneven else None
        evals[name] = (_uneven_tokens(rng, vocab, 1, b, t)[0] if uneven
                       else rng.randint(0, vocab, (b, t + 1)).astype(np.int32))
        if batches[name] is not None:
            inputs[world][f"{name}/tokens"] = batches[name]
        inputs[world][f"{name}/eval_tokens"] = evals[name]
        scenarios[world].append({"type": "train", "name": name, "axes": axes,
                                 "steps": STEPS, "params": f"{name}/params/",
                                 "cfg": dict(rules="pipe", **COMMON, **extra)})
        for fault in (f for f, on in FAULTS.items() if on == name):
            inputs[world][f"{fault}/eval_tokens"] = evals[name]
            scenarios[world].append({**scenarios[world][-1], "name": fault, "fault": fault})
    for i, (name, (world, schedule, v, _, _)) in enumerate(TOYS.items()):
        inputs[world].update(_toy_inputs(name, 20 + i))
        scenarios[world].append({"type": "pipe_toy", "name": name, "schedule": schedule,
                                 "v": v})
    # The checkpoint cell: 4 steps unbroken in JAX; 2 steps saved, then
    # resumed on pipe=2 and on one process.
    ck = jtrainer.Trainer(jtrainer.TrainConfig(**CKPT), axes=P2)
    ck.init_or_resume()
    for k, v in _flat(jax.tree.map(np.asarray, ck.state.params)).items():
        inputs[2][f"ckpt/params/{k}"] = v
    dirs = {k: str(tmp / k) for k in ("first", "one")}

    def ck_sc(name, phase, steps, directory, **kw):
        cfg = dict(CKPT, checkpoint_dir=directory, checkpoint_every=2)
        return {"type": "checkpoint", "name": name, "cfg": cfg, "axes": P2, "phase": phase,
                "steps": steps, "params": "ckpt/params/", **kw}

    scenarios[2] += [ck_sc("ck_first", "save", 2, dirs["first"], copies=[dirs["one"]]),
                     ck_sc("ck_same", "resume", 4, dirs["first"]),
                     ck_sc("ck_one", "resume", 4, dirs["one"], one_process=True)]
    jobs = {w: Job(tmp, w, inputs[w], scenarios[w], JOB_TIMEOUT) for w in (2, 4)}
    want = {name: _jax_steps(trainers[name], batches[name], evals[name])
            for name in SCENARIOS}
    data = jtrainer.synthetic_batches(ck.cfg)
    ck_losses, ck_norms = [], []
    for _ in range(4):
        ck.state, stats = ck.step_fn(ck.state, ck.place_batch(next(data)))
        ck_losses.append(float(stats["loss"]))
        ck_norms.append(float(stats["grad_norm"]))
    want["ckpt"] = {"losses": ck_losses, "norms": ck_norms,
                    "final": _flat(jax.tree.map(np.asarray, ck.state.params))}
    toys = {name: _toy_jax(name, inputs[TOYS[name][0]]) for name in TOYS}
    got = {w: job.results() for w, job in jobs.items()}
    return got, want, toys, inputs


def _ranks(got, name):
    return got[SCENARIOS[name][0]]


# ------------------------------------------------------------- schedule ----

GRID = [(p, k * p, v) for p in (1, 2, 3, 4) for k in (1, 2, 3) for v in (1, 2)]
TABLES = ("fwd", "bwd", "fwd_c", "bwd_c", "arr_f", "arr_b", "arr_f_c", "arr_b_c", "inject",
          "bank", "head")


@pytest.mark.parametrize("p,m,v", GRID)
def test_schedule_tables_equal_jax(p, m, v):
    want, got = jp1.simulate_1f1b(p, m, v), tp1.simulate_1f1b(p, m, v)
    for table in TABLES:
        np.testing.assert_array_equal(getattr(got, table), getattr(want, table), err_msg=table)
        assert getattr(got, table).dtype == getattr(want, table).dtype
    assert (got.p, got.m, got.v, got.stash_x, got.stash_dh, got.n_ticks) == (
        want.p, want.m, want.v, want.stash_x, want.stash_dh, want.n_ticks)
    assert [tp1._device_order(p, m, v, d) for d in range(p)] == [
        jp1._device_order(p, m, v, d) for d in range(p)]


def _corruptions(sched):
    """Broken copies of a valid schedule: a microbatch forwarded twice, a
    backward dropped, a forward moved before its upstream one, the
    in-flight window blown, a stash depth past the bound."""
    def with_(**arrays):
        return dataclasses.replace(sched, **{k: v for k, v in arrays.items()})

    out = {}
    fwd = sched.fwd.copy()
    t0 = int(np.argmax(fwd[:, 0] == 1))
    fwd[t0, 0] = 0
    out["duplicate F"] = with_(fwd=fwd)
    bwd = sched.bwd.copy()
    bwd[int(np.argmax(bwd[:, 0] >= 0)), 0] = -1
    out["missing B"] = with_(bwd=bwd)
    fwd = sched.fwd.copy()
    t1 = int(np.argmax(fwd[:, 1] == 0))
    fwd[t1, 1], fwd[0, 1] = -1, 0
    out["F dependency"] = with_(fwd=fwd)
    out["stash bound"] = with_(stash_x=sched.m + 1)
    return out


@pytest.mark.parametrize("what", ["duplicate F", "missing B", "F dependency", "stash bound"])
def test_validate_schedule_refuses_what_jax_refuses(what):
    bad_j = _corruptions(jp1.simulate_1f1b(2, 4))[what]
    bad_t = _corruptions(tp1.simulate_1f1b(2, 4))[what]
    with pytest.raises(AssertionError) as jerr:
        jp1.validate_schedule(bad_j)
    with pytest.raises(AssertionError) as terr:
        tp1.validate_schedule(bad_t)
    assert terr.value.args == jerr.value.args


@pytest.mark.parametrize("args", [(0, 1, 1), (2, 3, 2)])
def test_simulate_refuses_what_jax_refuses(args):
    with pytest.raises(ValueError) as jerr:
        jp1.simulate_1f1b(*args)
    with pytest.raises(ValueError) as terr:
        tp1.simulate_1f1b(*args)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("layers,p,v", [(8, 2, 2), (8, 4, 2), (12, 2, 3), (6, 2, 2)])
def test_interleave_permutation_equals_jax(layers, p, v):
    if layers % (p * v):
        with pytest.raises(ValueError) as jerr:
            jp1.interleave_layer_permutation(layers, p, v)
        with pytest.raises(ValueError) as terr:
            tp1.interleave_layer_permutation(layers, p, v)
        assert str(terr.value) == str(jerr.value)
        return
    for a, b in zip(tp1.interleave_layer_permutation(layers, p, v),
                    jp1.interleave_layer_permutation(layers, p, v)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ executors ----


@pytest.mark.parametrize("name", list(TOYS))
def test_toy_executor_matches_jax(runs, name):
    """Loss, every rank's gradient piece, the head's gradient and the
    inputs' cotangents of the port's executor on a toy stage against
    JAX's (GPipe: jax.grad through pipeline_apply; 1F1B: JAX's kernel)."""
    got, _, toys, _ = runs
    world, schedule, v, n_layers, m = TOYS[name]
    want = toys[name]
    per = n_layers // world
    for r, res in enumerate(got[world]):
        np.testing.assert_allclose(float(res[f"{name}/loss"]), want["loss"], rtol=1e-5)
        mine = slice(r * per, (r + 1) * per)
        for key in ("dw", "db"):
            np.testing.assert_allclose(res[f"{name}/{key}"], want[key][mine], atol=1e-5,
                                       err_msg=f"{key} rank {r}")
        np.testing.assert_allclose(res[f"{name}/dwo"], want["dwo"], atol=1e-5)
        np.testing.assert_allclose(res[f"{name}/dx"], want["dx"], atol=1e-5)
    if schedule == "1f1b":
        sched = tp1.simulate_1f1b(world, m, v)
        peaks = np.stack([res[f"{name}/stash_peak"] for res in got[world]])
        _check_peaks(peaks, sched)


# -------------------------------------------------------------- trainer ----


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_losses_and_grad_norms_match_jax_trainer(runs, name):
    got, want, _, _ = runs
    w = want[name]
    assert all(np.isfinite(w["losses"]))
    for r in _ranks(got, name):
        losses = [float(r[f"{name}/loss{i}"]) for i in range(STEPS)]
        norms = [float(r[f"{name}/grad_norm{i}"]) for i in range(STEPS)]
        np.testing.assert_allclose(losses, w["losses"], atol=1e-4)
        np.testing.assert_allclose(norms, w["norms"], rtol=1e-4)
        if "moe" in name:
            drops = [float(r[f"{name}/drop{i}"]) for i in range(STEPS)]
            np.testing.assert_allclose(drops, w["drops"], atol=1e-6)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_final_params_and_eval_match_jax_trainer(runs, name):
    """The gathered params after the last step and the eval loss (always
    the GPipe forward)."""
    got, want, _, _ = runs
    for r in _ranks(got, name):
        for leaf, w in want[name]["final"].items():
            np.testing.assert_allclose(r[f"{name}/final/{leaf}"], w, atol=2e-4, err_msg=leaf)
        np.testing.assert_allclose(float(r[f"{name}/eval_loss"]), want[name]["eval"],
                                   atol=2e-4)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicas_equal_and_pieces_split_over_pipe(runs, name):
    """Ranks holding the same piece hold the same bits after every step;
    every leaf but final_norm is split over pipe (the layers by layer,
    embed and lm_head by vocab)."""
    got, want, _, inputs = runs
    world, axes, _, _ = SCENARIOS[name]
    ranks = _ranks(got, name)
    leaves = list(want[name]["final"])
    for step in range(STEPS):
        for leaf in leaves:
            by_piece: dict = {}
            for r in ranks:
                by_piece.setdefault(tuple(r[f"{name}/piece/{leaf}"]), []).append(
                    r[f"{name}/shard{step}/{leaf}"])
            for pieces in by_piece.values():
                for other in pieces[1:]:
                    np.testing.assert_array_equal(other, pieces[0],
                                                  err_msg=f"{leaf} step {step + 1}")
    pipe = dict(axes)["pipe"]
    init = {leaf: inputs[world][f"{name}/params/{leaf}"] for leaf in leaves}
    whole = init["final_norm"].size
    total = sum(v.size for v in init.values())
    for r in ranks:
        held = sum(r[f"{name}/shard0/{leaf}"].size for leaf in leaves)
        assert held == (total - whole) // pipe + whole


def _check_peaks(peaks, sched):
    """The ranks' [input, cotangent] stash peaks against the schedule: at
    most stash_x and stash_dh, and at v=1 stash_x itself (the first stage's
    in-flight window, min(M, P))."""
    assert peaks[:, 0].max() <= sched.stash_x and peaks[:, 1].max() <= sched.stash_dh, peaks
    if sched.v == 1:
        assert peaks[:, 0].max() == sched.stash_x == min(sched.m, sched.p), peaks


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_break_the_limits(runs, fault):
    """Each planted fault moves a step's loss or grad_norm past the
    tolerances its scenario's sound run keeps against the JAX Trainer."""
    got, want, _, _ = runs
    w = want[FAULTS[fault]]
    for r in got[SCENARIOS[FAULTS[fault]][0]]:
        loss = max(abs(float(r[f"{fault}/loss{i}"]) - w["losses"][i]) for i in range(STEPS))
        norm = max(abs(float(r[f"{fault}/grad_norm{i}"]) - w["norms"][i]) / w["norms"][i]
                   for i in range(STEPS))
        assert loss > 1e-4 or norm > 1e-4, (fault, loss, norm)


def test_stash_stays_within_the_schedule(runs):
    """1F1B's executor never holds more live stage inputs of a chunk than
    the schedule's stash_x, whatever M."""
    got, _, _, _ = runs
    for name, (world, axes, extra, _) in SCENARIOS.items():
        if extra.get("pipeline_schedule") != "1f1b":
            continue
        sched = tp1.simulate_1f1b(dict(axes)["pipe"], extra.get("microbatches", 4),
                                  extra.get("virtual_stages", 1))
        for step in range(STEPS):
            _check_peaks(np.stack([r[f"{name}/stash_peak{step}"] for r in _ranks(got, name)]),
                         sched)


def _stage_zero_live(p: int, m: int, v: int) -> int:
    """The most microbatch inputs global stage 0 holds at once under 1F1B:
    each from the tick it runs its forward to the tick of its backward."""
    sched = tp1.simulate_1f1b(p, m, v)
    live = peak = 0
    for t in range(sched.n_ticks):
        live += int(sched.fwd[t, 0] >= 0 and sched.fwd_c[t, 0] == 0)
        peak = max(peak, live)
        live -= int(sched.bwd[t, 0] >= 0 and sched.bwd_c[t, 0] == 0)
    return peak


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "1f1b_v2", "dp2_1f1b", "seq_ring_1f1b"])
def test_only_stage_zero_holds_the_embedding_output(runs, name):
    """The embedding's output and its cotangent go through the pipeline a
    microbatch at a time (this rank's rows and positions, [B/M, T, D]):
    the first rank of pipe holds the outputs global stage 0 keeps live
    (all M under GPipe, the schedule's depth under 1F1B) and two
    cotangents at once (its own and the broadcast copy); every other rank
    at most one output and one cotangent. For the table's gradient each
    rank keeps the cotangent rows whose ids fall in its vocabulary slice:
    the ranks of pipe split the batch's cotangent between them, none
    holds it whole (the JAX package shards both over pipe)."""
    got = runs[0]
    world, axes, extra, _ = SCENARIOS[name]
    shape = dict(axes)
    m = extra.get("microbatches", 4)
    rows = extra["batch_size"] // shape.get("data", 1) // extra.get("accum_steps", 1)
    micro = rows // m * extra["seq_len"] // shape.get("seq", 1) * 64 * 4  # llama-tiny dim, f32
    if extra.get("pipeline_schedule") == "1f1b":
        live = _stage_zero_live(shape["pipe"], m, extra.get("virtual_stages", 1))
    else:
        live = m
    kept: dict = {}
    for rank, r in enumerate(got[world]):
        mesh = Mesh(axes, list(range(world)), "cpu", rank=rank)
        stage = mesh.axis("pipe").index
        group = tuple(mesh.axis(a).index for a in shape if a != "pipe")
        for step in range(STEPS):
            x, d_x, d_rows = r[f"{name}/embed_held{step}"].tolist()
            assert [x, d_x] == ([live * micro, 2 * micro] if stage == 0 else [micro, micro])
            assert 0 < d_rows < m * micro, (rank, step, d_rows)
            kept.setdefault((group, step), []).append(d_rows)
    for (group, step), parts in kept.items():
        assert len(parts) == shape["pipe"] and sum(parts) == m * micro, (group, step, parts)


def test_z_loss_term_reported_by_gpipe_only(runs):
    """GPipe reports the z-loss term as JAX does; 1F1B carries the z-loss in
    its loss but no term, exactly as JAX's 1F1B."""
    got, want, _, _ = runs
    assert np.all(np.isfinite(want["gpipe_zloss"]["zterms"]))
    assert np.all(np.isnan(want["1f1b_zloss"]["zterms"]))
    assert "z_loss_term" in want["1f1b_zloss"]["eval_stats"]  # the eval is GPipe's
    np.testing.assert_allclose(want["gpipe_zloss"]["losses"], want["1f1b_zloss"]["losses"],
                               atol=1e-5)


def test_uneven_mask_is_the_global_masked_mean(runs):
    """Under the uneven mask the first step's loss is the mean over every
    kept label of the global batch, on every rank. Each (microbatch, data
    rank) holds one row here and the rows keep different counts, so the
    mean of the rows' own means differs from it by far more than the
    tolerance."""
    from oim_tpu.models import llama as jllama
    from tests.torch_parallel_worker import unflatten

    got, want, _, inputs = runs
    name = "uneven_1f1b"
    tokens = inputs[4][f"{name}/tokens"][0]
    prefix = f"{name}/params/"
    params = unflatten({k[len(prefix):]: v for k, v in inputs[4].items()
                        if k.startswith(prefix)})
    cfg = jllama.tiny()
    own = [float(jllama.loss_fn(params, tokens[i:i + 1], cfg)) for i in range(len(tokens))]
    kept = [(tokens[i, 1:] != -1).sum() for i in range(len(tokens))]
    assert len(set(kept)) > 1
    first = want[name]["losses"][0]
    assert abs(np.mean(own) - first) > 10 * 1e-4
    np.testing.assert_allclose(np.dot(own, kept) / sum(kept), first, atol=1e-5)
    for r in _ranks(got, name):
        np.testing.assert_allclose(float(r[f"{name}/loss0"]), first, atol=1e-4)


@pytest.mark.parametrize("name,first", [("ck_same", 3), ("ck_one", 3)])
def test_checkpoint_under_pipe_resumes(runs, name, first):
    """A checkpoint of 1F1B under pipe=2 at step 2, each rank writing its
    layer and vocab pieces, resumed on pipe=2 and on one process, trains
    on to step 4 as JAX's unbroken run does."""
    got, want, _, _ = runs
    ranks = got[2][:1] if name == "ck_one" else got[2]
    w = want["ckpt"]
    for r in ranks:
        assert list(r[f"{name}/steps"]) == [3, 4]
        np.testing.assert_allclose(r[f"{name}/losses"], w["losses"][first - 1:], atol=1e-4)
        np.testing.assert_allclose(r[f"{name}/norms"], w["norms"][first - 1:], rtol=1e-4)
        for leaf, v in w["final"].items():
            np.testing.assert_allclose(r[f"{name}/final/{leaf}"], v, atol=2e-4, err_msg=leaf)
    for r in got[2]:
        np.testing.assert_allclose(r["ck_first/losses"], w["losses"][:2], atol=1e-4)


# ------------------------------------------------------------ refusals ----

PIPE2 = Mesh(P2, [0, 1], "cpu")  # shape only: no process group


def _jax_error(cfg: dict, axes, step: bool = False) -> str:
    with pytest.raises(ValueError) as err:
        tr = jtrainer.Trainer(jtrainer.TrainConfig(**COMMON, **cfg), axes=axes)
        if step:
            tr.init_or_resume()
            batch = next(jtrainer.synthetic_batches(tr.cfg))
            tr.step_fn(tr.state, tr.place_batch(batch))
    return str(err.value)


def _jax_kernel_m_by_p_error(m: int, p: int) -> str:
    """JAX's 1F1B kernel's own refusal of M % P (its Trainer meets
    shard_map's divisibility error on the microbatch dim first)."""
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as PS

    from oim_tpu.parallel.compat import shard_map

    mesh = JMesh(np.array(jax.devices()[:p]), ("pipe",))
    x = jnp.zeros((m, 1, 2), jnp.float32)
    fn = shard_map(lambda x: jp1.pipeline_1f1b_value_and_grad(
        lambda h, w: h, lambda h, hp, t: jnp.sum(h), {}, {}, x, x, jnp.ones((m,)), m)[0],
        mesh=mesh, in_specs=PS(), out_specs=PS(), check_vma=False)
    with pytest.raises(ValueError) as err:
        fn(x)
    return str(err.value)


@pytest.mark.parametrize("case", ["no_pipe_axis", "schedule", "resnet", "batch", "m_by_p",
                                  "layers_by_pv"])
def test_refusals_carry_the_jax_trainers_errors(case):
    cfg, axes, step = dict(rules="pipe", model="llama-tiny"), P2, False
    if case == "no_pipe_axis":
        axes = [("data", 1)]
    elif case == "schedule":
        cfg["pipeline_schedule"] = "zb-h1"
    elif case == "resnet":
        cfg["model"] = "resnet50"
    elif case == "batch":
        cfg.update(batch_size=6, seq_len=8)
        axes, step = [("data", 1), ("pipe", 1)], True
    elif case == "m_by_p":
        cfg.update(pipeline_schedule="1f1b", microbatches=3, batch_size=6, seq_len=8)
        step = True
    else:
        cfg.update(pipeline_schedule="1f1b", virtual_stages=2, batch_size=4, seq_len=8)
        step = True
    if case == "m_by_p":
        want = _jax_kernel_m_by_p_error(3, 2)
        assert "not evenly divisible" in _jax_error(cfg, axes, step)  # shard_map's
    else:
        want = _jax_error(cfg, axes, step)
    tcfg = ttrainer.TrainConfig(**COMMON, **cfg)
    with pytest.raises(ValueError) as err:
        if case == "batch":
            tr = ttrainer.Trainer(tcfg, device="cpu", mesh=Mesh(axes, [0], "cpu"))
            tr.init()
            tr.step_fn(tr.state, tr.place_batch(next(ttrainer.synthetic_batches(tcfg))))
        else:
            tcfg.check_supported(Mesh(axes, list(range(int(np.prod([s for _, s in axes])))),
                                      "cpu"))
    assert str(err.value) == want


def test_port_refuses_what_it_does_not_split_under_pipe():
    """The stage split's own refusals (layers a stage count, or a stage
    count times the virtual stages, does not divide); an axis the rules do
    not split over is replicated, not refused
    (tests/test_torch_tp_headsplit.py)."""
    cfg = ttrainer.TrainConfig
    with pytest.raises(ValueError, match="3 layers not divisible by 2 stages"):
        cfg(rules="pipe", model_overrides={"n_layers": 3}).check_supported(PIPE2)
    with pytest.raises(ValueError, match="2 layers not divisible by pipe 2 x virtual 2"):
        cfg(rules="pipe", pipeline_schedule="1f1b", virtual_stages=2,
            model_overrides={"n_layers": 2}).check_supported(PIPE2)
    cfg(rules="pipe").check_supported(PIPE2)
    cfg(rules="pipe", pipeline_schedule="1f1b", virtual_stages=2,
        model_overrides={"n_layers": 4}).check_supported(PIPE2)


# ------------------------------------------------------------------ CLI ----


def test_cli_pipe_flags_match_jax_cli(monkeypatch):
    from oim_tpu.cli import oim_trainer as jcli
    from oim_tpu_torch.cli import oim_trainer as tcli

    argv = ["--rules", "pipe", "--mesh", "data=1,pipe=2", "--microbatches", "8",
            "--pipeline-schedule", "1f1b", "--virtual-stages", "2", "--steps", "3"]
    seen = {}

    class Catch:
        def __init__(self, cfg, **kw):
            seen["cfg"], seen["axes"] = cfg, kw.get("axes")

        def run(self, **kw):
            return 0.0

    monkeypatch.setattr(jcli, "Trainer", Catch)
    jcli.main(argv + ["--log-level", "error"])
    got = tcli.config_from_args(tcli.parse_args(argv))
    for key in ("rules", "microbatches", "pipeline_schedule", "virtual_stages"):
        assert getattr(got, key) == getattr(seen["cfg"], key), key
    defaults = tcli.config_from_args(tcli.parse_args([]))
    jdefaults = jtrainer.TrainConfig()
    for key in ("microbatches", "pipeline_schedule", "virtual_stages"):
        assert getattr(defaults, key) == getattr(jdefaults, key), key


def test_cli_under_torchrun_pipelines_on_two_ranks():
    """``torchrun --standalone`` starts two CPU ranks of the CLI under
    ``--rules pipe --mesh data=1,pipe=2 --pipeline-schedule 1f1b``; each
    logs the global loss, equal to one process's dp run on the same
    batches."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    common = ["--device", "cpu", "--steps", "2", "--batch-size", "4", "--seq-len", "16",
              "--log-every", "1", "--log-format", "json", "--warmup-steps", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "oim_tpu_torch.cli.oim_trainer", "--rules", "pipe", "--mesh",
         "data=1,pipe=2", "--pipeline-schedule", "1f1b", *common], capture_output=True,
        text=True, timeout=180, env=env)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "oim_tpu_torch.cli.oim_trainer", *common],
                         capture_output=True, text=True, timeout=180, env=env)
    assert one.returncode == 0, one.stderr[-3000:]

    def logged(text):
        return [json.loads(line)["loss"] for line in text.splitlines()
                if line.startswith("{") and '"msg": "step"' in line]

    both, single = logged(ranks.stderr + ranks.stdout), logged(one.stderr)
    assert len(single) == 2 and len(both) == 4
    np.testing.assert_allclose(sorted(both), sorted(single * 2), atol=1e-5)
