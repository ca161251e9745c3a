"""The families (``benchmark/families/<family>.py``), on the CPU: the Llama
family gives the counts, weights and reference that the harness gave
before they moved there (values pinned from it), a family found by name
from outside the repository runs through both drivers with its own
reference deciding ``correct``, and a configuration that names no family,
or a missing one, is refused."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.utils.checkpoint as ckpt

from benchmark import run
from benchmark.harness import manifest, serve, train, trace
from benchmark.test_bench_drivers import (LLAMA, SERVE_LIMITS, SERVE_MIX, TINY, TRAIN_LIMITS,
                                          TRAIN_MIX)
from benchmark.test_bench_units import _dims

CONTRACT = ("dims", "make_params", "count_params", "serve_config", "train_config",
            "logits_at", "loss", "forward_flops", "prompt_flops", "train_flops",
            "weight_bytes", "decode_step_bytes", "decode_bytes")


# -- every configuration names a family that has the whole contract ------------------

@pytest.mark.parametrize("config", [c["name"] for c in manifest.load(manifest.HERE.parent)
                                    ["configs"]])
def test_each_configuration_names_a_family_with_the_contract(config):
    fam, d = _dims(config)
    assert [f for f in CONTRACT if not callable(getattr(fam, f, None))] == []
    assert dataclasses.is_dataclass(d) and d.__dataclass_params__.frozen
    assert (d.name, d.dtype) == (config, "bfloat16") and d.vocab > 0


def test_a_family_loads_once_and_its_reference_loads_nothing_of_the_program():
    assert manifest.family("llama") is manifest.family("llama")
    code = textwrap.dedent("""
        import sys, torch
        import torch.utils.checkpoint as ckpt
        from benchmark.harness import guard, manifest
        fam = manifest.family("llama")
        d = fam.Dims(name="t", vocab=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                     head_dim=16, mlp_dim=48, rope_theta=1e4, norm_eps=1e-6, dtype="float32")
        p = fam.make_params(d, 1, "cpu")
        fam.logits_at(p, d, list(range(9)), [3, 8])
        fam.loss(p, d, torch.zeros(1, 9, dtype=torch.long), None, ckpt)
        print(sorted(m for m in sys.modules if m.split(".")[0] == "oim_tpu_torch"),
              guard.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(manifest.HERE.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


# -- (a) the Llama family's counts, pinned to the values the harness gave before -------

PINNED_COUNTS = {
    "mistral-7b": {
        "count_params": 7248023552, "count_params_active": 7248023552,
        "weight_bytes_0": 14228144128, "weight_bytes_1": 14228152320,
        "forward_flops": {1: 14227603456.0, 1020: 14761852928.0, 4096: 16374562816.0},
        "prompt_flops": {1: 14227603456.0, 1020: 14784622755840.0, 4096: 62673236525056.0},
        "train_flops_2_8192": 804855396433920.0, "decode_step_bytes": 14792171520},
    "mixtral-8x7b-2l": {
        "count_params": 3164688384, "count_params_active": 1050759168,
        "weight_bytes_0": 6067404800, "weight_bytes_1": 6067412992,
        "forward_flops": {1: 1839366144.0, 1020: 1872756736.0, 4096: 1973551104.0},
        "prompt_flops": {1: 1839366144.0, 1020: 1893182668800.0, 4096: 7808854523904.0},
        "train_flops_2_8192": 97004789170176.0, "decode_step_bytes": 6102679552},
}


def _counts(fam, d) -> dict:
    return {"count_params": fam.count_params(d),
            "count_params_active": fam.count_params(d, active=True),
            "weight_bytes_0": fam.weight_bytes(d, 0), "weight_bytes_1": fam.weight_bytes(d, 1),
            "forward_flops": {c: fam.forward_flops(d, c) for c in (1, 1020, 4096)},
            "prompt_flops": {c: fam.prompt_flops(d, c) for c in (1, 1020, 4096)},
            "train_flops_2_8192": fam.train_flops(d, 2, 8192),
            "decode_step_bytes": fam.decode_step_bytes(d, [800, 1500, 2000])}


@pytest.mark.parametrize("config,count", [(c, k) for c in PINNED_COUNTS
                                          for k in PINNED_COUNTS[c]])
def test_llama_counts_equal_the_pinned_values(config, count):
    fam, d = _dims(config)
    assert _counts(fam, d)[count] == PINNED_COUNTS[config][count]


def test_decode_step_bytes_count_the_kv_per_token():
    fam, d = _dims("mistral-7b")
    kv_token = 2 * 32 * 8 * 128 * 2  # K and V, 32 layers, bf16
    assert fam.decode_step_bytes(d, [10, 20]) - fam.decode_step_bytes(d, [9, 20]) == kv_token
    assert fam.decode_bytes(d, 1, 2, 30) == fam.decode_step_bytes(d, [10, 20])


# -- (b) the Llama family's weights and reference, to the bit ---------------------------

DENSE = LLAMA.Dims(name="tiny", mlp_dim=192, **TINY)
MOE = LLAMA.Dims(name="tiny", mlp_dim=96, n_experts=4, top_k=2, aux_weight=0.02,
                 capacity_factor=1.25, vocab_chunk=64, **TINY)
PINNED_SUMS = {
    "params_dense": "2fd0b5e13f211bff66ce0ce43f2379ab9bfe1b6bfd9cdf90ee55bdb5412cd506",
    "logits_dense_None": "e633185c7ba0723cdcdd0c717968a039447f09c2f958b7d7e1e66962f1f5eaae",
    "logits_dense_fp8": "7b0f6d995c4f5e4b999c6027555497a550f34a80e051aebd7dee07161357a3b6",
    "loss_dense_None": "4c9a44d57fc30cd13aa7fa9901eb7df817ccaa6df113f2c762e41d03a640e4b5",
    "loss_dense_fp8": "cd1b12efc093b4b5a968cc9bfdf451a2df6c6b3a4a29512ac6652d1623c5ef59",
    "params_moe": "11265c558d4a04684e45967703f094d045110678f79e5b36501a80434542a391",
    "logits_moe_None": "e2dcf8dbb24426b2323a2de1eea282b66333890b1e56f503ca319915e07105f4",
    "logits_moe_fp8": "5d9edd8575d7d1fafbb6ef5a4cd0d95a8174a11186fb2269b9462783f346ff1c",
    "loss_moe_None": "2276cab37be905d96c08d9d1d196f1cc19205e9e6de1212342480c81d5f07554",
    "loss_moe_fp8": "a53cdf47233da9b882a94adadb58a3b3c9a1d6997a2ef3b6f5a4b1481c679843",
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().float().numpy().tobytes())
    return h.hexdigest()


def _leaves(tree) -> list:
    return [t for _, t in train.leaf_items(tree)]


def _sums(tag: str) -> dict:
    """The checksums of one tiny model: its float32 weights from a seed,
    its reference's logits and its loss with the loss's gradients, in
    float32 and under the fp8 control."""
    d = {"dense": DENSE, "moe": MOE}[tag]
    rng = np.random.default_rng(5)
    seq = rng.integers(0, 256, 40).tolist()
    batch = torch.from_numpy(rng.integers(0, 256, (2, 33)).astype(np.int64))
    p = LLAMA.make_params(d, 2**31 + 7, "cpu")
    out = {f"params_{tag}": _digest(_leaves(p))}
    names = [n for n, _ in train.leaf_items(p)]
    for quant in (None, "fp8"):
        out[f"logits_{tag}_{quant}"] = _digest([LLAMA.logits_at(p, d, seq, range(10, 40),
                                                                quant=quant)])
        leaves = [t.detach().float().clone().requires_grad_(True) for t in _leaves(p)]
        loss = LLAMA.loss(train._unflatten(names, leaves), d, batch, quant, ckpt)
        out[f"loss_{tag}_{quant}"] = _digest([loss.detach(),
                                              *torch.autograd.grad(loss, leaves)])
    return out


@pytest.mark.parametrize("tag", ["dense", "moe"])
def test_llama_weights_and_reference_equal_the_pinned_checksums(tag):
    got = _sums(tag)
    assert got == {k: v for k, v in PINNED_SUMS.items() if f"_{tag}" in k}


@pytest.mark.parametrize("tag", ["dense", "moe"])
def test_llama_bf16_weights_are_the_one_flat_draw(tag):
    """In bf16 (whose CPU draw differs between torch builds, so no checksum
    is pinned) every leaf is, to the bit, its slice of one flat bf16 draw
    times its scale, in ``leaf_shapes``' order, and the router the float32
    draw after it, as the harness drew them before the move."""
    d = dataclasses.replace({"dense": DENSE, "moe": MOE}[tag], dtype="bfloat16")
    got = LLAMA.make_params(d, 12345, "cpu")
    gen = torch.Generator().manual_seed(12345)
    shapes = LLAMA.leaf_shapes(d)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in shapes), generator=gen,
                       dtype=torch.bfloat16)
    want, at = {}, 0
    for path, shape, scale in shapes:
        want[".".join(path)] = flat[at:at + math.prod(shape)].view(shape) * scale
        at += math.prod(shape)
    if d.n_experts:
        want["layers.moe.router"] = torch.randn((d.n_layers, d.dim, d.n_experts), generator=gen,
                                                dtype=torch.float32) * d.dim ** -0.5
    leaves = dict(train.leaf_items(got))
    for name, leaf in want.items():
        assert leaves[name].dtype == leaf.dtype and torch.equal(leaves[name], leaf), name
    assert all(torch.equal(v, torch.ones_like(v)) for k, v in leaves.items() if "norm" in k)
    assert set(leaves) - set(want) == {k for k in leaves if "norm" in k}


# -- (c) a family from outside the repository, through both drivers ----------------------

TOY = '''
"""A toy family: a dense GQA decoder under keys of its own."""
import dataclasses

import torch
import torch.nn.functional as F

from benchmark.harness import flops, reference, weights
from benchmark.harness.reference import _proj, causal_attention, rmsnorm

ROPE = {rope}


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    vocab: int
    width: int
    depth: int
    heads: int
    kv_heads: int
    ffn: int
    theta: float
    dtype: str

    @property
    def hd(self):
        return self.width // self.heads


def dims(conf):
    return Dims(**{{f.name: conf[f.name] for f in dataclasses.fields(Dims)}})


def _shapes(d):
    L, D, q, kv = d.depth, d.width, d.heads * d.hd, d.kv_heads * d.hd
    return [(("embed",), (d.vocab, D), 0.05), (("layers", "wq"), (L, D, q), D ** -0.5),
            (("layers", "wk"), (L, D, kv), D ** -0.5), (("layers", "wv"), (L, D, kv), D ** -0.5),
            (("layers", "wo"), (L, q, D), q ** -0.5),
            (("layers", "w_gate"), (L, D, d.ffn), D ** -0.5),
            (("layers", "w_up"), (L, D, d.ffn), D ** -0.5),
            (("layers", "w_down"), (L, d.ffn, D), d.ffn ** -0.5),
            (("lm_head",), (D, d.vocab), D ** -0.5)]


def make_params(d, seed, device):
    ones = [(("layers", "attn_norm"), (d.depth, d.width)),
            (("layers", "mlp_norm"), (d.depth, d.width)), (("final_norm",), (d.width,))]
    return weights.draw(_shapes(d), ones, [], d.dtype, seed, device)


def count_params(d, active=False):
    return sum(s[0] * s[1] * (s[2] if len(s) > 2 else 1) for _, s, _ in _shapes(d))


def serve_config(d, mix, dtype):
    from oim_tpu_torch.models import llama

    return llama.Config(vocab=d.vocab, dim=d.width, n_layers=d.depth, n_heads=d.heads,
                        n_kv_heads=d.kv_heads, head_dim=d.hd, mlp_dim=d.ffn,
                        max_seq=mix["engine"]["max_seq"], rope_theta=d.theta, dtype=dtype)


def train_config(d, mix):
    from oim_tpu_torch.train import TrainConfig

    over = dict(vocab=d.vocab, dim=d.width, n_layers=d.depth, n_heads=d.heads,
                n_kv_heads=d.kv_heads, head_dim=d.hd, mlp_dim=d.ffn, max_seq=mix["seq"],
                rope_theta=d.theta, dtype=weights.DTYPES[d.dtype], n_experts=0)
    opt = mix["optimizer"]
    return TrainConfig(model="llama3-8b", model_overrides=over, batch_size=mix["batch"],
                       seq_len=mix["seq"], lr=opt["lr"], warmup_steps=opt["warmup_steps"],
                       total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
                       log_every=mix.get("log_every", 10))


def _block(x, w, d, quant):
    B, T, _ = x.shape
    inv = 1.0 / (d.theta ** (torch.arange(0, d.hd, 2, device=x.device).float() / d.hd))
    ang = torch.arange(T, device=x.device).float()[:, None] * inv[None, :]
    h = rmsnorm(x, w["attn_norm"], 1e-6)
    q = _proj(h, w["wq"], quant).view(B, T, d.heads, d.hd)
    k = _proj(h, w["wk"], quant).view(B, T, d.kv_heads, d.hd)
    if ROPE:
        q, k = (reference.rope(t, torch.cos(ang), torch.sin(ang)) for t in (q, k))
    v = _proj(h, w["wv"], quant).view(B, T, d.kv_heads, d.hd)
    x = x + _proj(causal_attention(q, k, v).reshape(B, T, -1), w["wo"], quant)
    h = rmsnorm(x, w["mlp_norm"], 1e-6)
    return x + _proj(F.silu(_proj(h, w["w_gate"], quant)) * _proj(h, w["w_up"], quant),
                     w["w_down"], quant)


@torch.no_grad()
def logits_at(params, d, tokens, rows, quant=None):
    ids = torch.as_tensor(tokens, dtype=torch.long)
    x = params["embed"][ids].float()[None]
    for i in range(d.depth):
        x = _block(x, reference.layer_weights(params, i), d, quant)
    h = rmsnorm(x[0, torch.as_tensor(rows)], params["final_norm"].float(), 1e-6)
    return _proj(h, params["lm_head"].float(), quant)


def loss(tree, d, tokens, quant, ckpt):
    x = tree["embed"][tokens[:, :-1]]
    for i in range(d.depth):
        x = _block(x, {{k: v[i] for k, v in tree["layers"].items()}}, d, quant)
    logits = _proj(rmsnorm(x, tree["final_norm"], 1e-6), tree["lm_head"], quant)
    return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())


def forward_flops(d, context):
    return 2.0 * count_params(d) + 4.0 * d.depth * d.width * context


def prompt_flops(d, n):
    return 2.0 * count_params(d) * n + 4.0 * d.depth * d.width * flops.causal_pairs(n)


def train_flops(d, batch, seq):
    return 3.0 * batch * prompt_flops(d, seq)


def weight_bytes(d, rows):
    return 4 * count_params(d)


def decode_bytes(d, steps, row_steps, kv_tokens):
    return steps * weight_bytes(d, 0) + 2 * d.depth * d.kv_heads * d.hd * 4 * (kv_tokens
                                                                            + row_steps)


def decode_step_bytes(d, contexts):
    contexts = list(contexts)
    return decode_bytes(d, 1, len(contexts), sum(contexts))
'''
TOY_CONFIG = {"name": "toy-dense", "family": "toy", "vocab": 256, "width": 64, "depth": 2,
              "heads": 4, "kv_heads": 2, "ffn": 128, "theta": 10000.0, "dtype": "float32"}


@pytest.fixture
def toy(tmp_path):
    """The toy family's root: ``families/toy.py`` and ``families/toy_norope.py``
    (its reference without RoPE), ``configs/toy-dense.json``."""
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "toy.py").write_text(TOY.format(rope=True))
    (tmp_path / "families" / "toy_norope.py").write_text(TOY.format(rope=False))
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "toy-dense.json").write_text(json.dumps(TOY_CONFIG))
    return tmp_path


def _toy(root, name: str):
    conf = manifest.config(root / "configs" / "toy-dense.json")
    fam = manifest.family(name, root=root)
    return fam, fam.dims(conf)


@pytest.mark.parametrize("variant", ["toy", "toy_norope"])
def test_a_family_of_its_own_serves_and_its_reference_decides(toy, variant):
    fam, d = _toy(toy, variant)
    res = serve.run({"name": "toy"}, fam, d, SERVE_MIX, SERVE_LIMITS, 2**31 + 21, 3.0, False,
                    "cpu", time.monotonic())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["check"]["tokens_compared"] >= SERVE_LIMITS["sample"]["min_served_tokens"]
    assert res["check"]["ok"] is (variant == "toy"), res["check"]
    assert res["context"]["family"] is fam and res["context"]["window_flops"] > 0


@pytest.mark.parametrize("variant", ["toy", "toy_norope"])
def test_a_family_of_its_own_trains_and_its_reference_decides(toy, variant):
    fam, d = _toy(toy, variant)
    res = train.run({"name": "toy"}, fam, d, TRAIN_MIX, TRAIN_LIMITS, 2**31 + 21, 0.5, False,
                    "cpu", time.monotonic())
    assert res["check"]["ok"] is (variant == "toy"), res["check"]
    assert res["context"]["step_flops"] == fam.train_flops(d, TRAIN_MIX["batch"],
                                                           TRAIN_MIX["seq"])


# -- (d) a configuration that names no family, or a missing one ---------------------------

def test_a_configuration_without_a_family_is_refused(tmp_path):
    path = tmp_path / "bare.json"
    path.write_text(json.dumps({k: v for k, v in TOY_CONFIG.items() if k != "family"}))
    with pytest.raises(ValueError, match=str(path)):
        manifest.config(path)
    bench = {"configs": [{"name": "bare", "file": str(path)}]}
    with pytest.raises(ValueError, match="names no family"):
        run.run_cell(bench, {"name": "bare.x", "config": "bare", "traffic": "conv"}, 1, 1.0,
                     False, "cpu", time.monotonic())


def test_a_missing_family_is_refused_with_its_path(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "families" / "nowhere.py")):
        manifest.family("nowhere", root=tmp_path)
    path = tmp_path / "lost.json"
    path.write_text(json.dumps({**TOY_CONFIG, "family": "nowhere"}))
    bench = {"configs": [{"name": "lost", "file": str(path)}]}
    with pytest.raises(FileNotFoundError, match="nowhere.py"):
        run.run_cell(bench, {"name": "lost.x", "config": "lost", "traffic": "conv"}, 1, 1.0,
                     False, "cpu", time.monotonic())


# -- the breakdown's categories --------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["paged_decode_split", "paged_decode_merge",
                                    "paged_decode_mma"])
def test_the_paged_decode_kernels_have_a_category_of_their_own(kernel):
    assert trace.category(f"void {kernel}(Params)") == "attention kernels (paged decode)"
    assert trace.category("void oimflash::flash_fwd<128>()") == "attention kernels (K1-K3)"
