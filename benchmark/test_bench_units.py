"""The yardstick's arithmetic, traffic and manifest, on the CPU."""

from __future__ import annotations

import json
import re
import sys

import numpy as np
import pytest

from benchmark.harness import flops, guard, manifest, stats, traffic


# -- traffic -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["conv", "code"])
def test_traffic_repeats_from_a_seed(name):
    mix = traffic.load(name)
    a, b = traffic.Requests(mix, 2**31 + 11, 32768), traffic.Requests(mix, 2**31 + 11, 32768)
    assert [a.lengths(i) for i in range(200)] == [b.lengths(i) for i in range(200)]
    assert a.tokens(5) == b.tokens(5)
    c = traffic.Requests(mix, 2**31 + 12, 32768)
    assert a.tokens(5) != c.tokens(5)


@pytest.mark.parametrize("name", ["conv", "code"])
def test_traffic_keeps_medians_clips_and_the_set_of_sizes(name):
    mix = traffic.load(name)
    prompt, output = traffic.block_lengths(mix)
    assert np.median(prompt) == pytest.approx(mix["prompt"]["median"], abs=1)
    assert np.median(output) == pytest.approx(mix["output"]["median"], abs=1)
    for lengths, spec in ((prompt, mix["prompt"]), (output, mix["output"])):
        assert lengths.min() >= spec["min"] and lengths.max() <= spec["max"]
    n = mix["block"]
    for seed in (1, 2**31 + 99):
        reqs = traffic.Requests(mix, seed, 100)
        got = sorted(reqs.lengths(i) for i in range(n))
        # every cycle of `block` requests holds each stratum once, whatever the seed
        assert sorted(p for p, _ in got) == sorted(prompt.tolist())
        assert sorted(o for _, o in got) == sorted(output.tolist())
        assert reqs.max_prompt() + mix["output"]["max"] <= mix["engine"]["max_seq"]


def test_halton_orders_are_permutations():
    for base in (2, 3):
        assert sorted(traffic.halton_ranks(64, base).tolist()) == list(range(64))


# -- percentiles and rates ---------------------------------------------------

def test_percentile_nearest_rank_and_missing():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    # an unanswered request sorts last: 6 of 100 missing put the p95 on one
    ys = list(range(94)) + [stats.MISSING] * 6
    assert stats.percentile(ys, 95) == stats.MISSING
    ys = list(range(95)) + [stats.MISSING] * 5
    assert stats.percentile(ys, 95) == 94
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_gaps_and_counts_in_the_window():
    times = [0.5, 1.0, 1.5, 2.5, 3.5]
    assert stats.gaps_in_window(times, 1.0, 3.0) == [0.5, 1.0]
    assert stats.count_in_window(times, 1.0, 3.0) == 3


# -- operations and bytes ----------------------------------------------------

@pytest.mark.parametrize("kernel,gflop,mb", [("k1", 68.8, 84.4), ("k2", 137.5, 101.7),
                                              ("k3", 103.1, 118.5)])
def test_flash_counts_reproduce_the_kernel_table(kernel, gflop, mb):
    f, b = flops.flash_counts(kernel, 2, 2048, 32, 8, 128)
    assert round(f / 1e9, 1) == gflop
    assert round(b / 1e6, 1) == mb


def _dims(config: str):
    conf = manifest.config(manifest.HERE / "configs" / f"{config}.json")
    fam = manifest.family(conf["family"])
    return fam, fam.dims(conf)


def test_model_counts():
    fam, d = _dims("mistral-7b")
    # Mistral-7B: 7.25e9 parameters, 14.5 GB in bf16
    assert fam.count_params(d) == pytest.approx(7.248e9, rel=1e-3)
    assert fam.weight_bytes(d, 0) == pytest.approx(2 * (fam.count_params(d)
                                                        - d.vocab * d.dim), rel=1e-3)
    assert fam.prompt_flops(d, 1) == pytest.approx(fam.forward_flops(d, 1))
    fam, m = _dims("mixtral-8x7b-2l")
    assert fam.count_params(m) == pytest.approx(3.165e9, rel=1e-3)
    # a step of 2 x 8192 tokens: ~97 TFLOP
    assert fam.train_flops(m, 2, 8192) == pytest.approx(9.7e13, rel=0.05)


# -- the manifest --------------------------------------------------------------

def _bench():
    return manifest.load(manifest.HERE.parent)


def test_names_units_and_files():
    bench = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert manifest.NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for c in bench["configs"]:
        conf = json.loads((manifest.HERE.parent / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        for key in ("assumed", "deployment", "reduced", "source"):
            assert key in conf
    for w in bench["workloads"]:
        assert traffic.load(w["traffic"])
        assert manifest.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_every_per_layer_metric_moves_what_its_cells_report():
    bench = _bench()
    for m in bench["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            e2e = [x["name"] for x in manifest.metrics_for(bench, cell, "end_to_end")]
            assert m["moves"] in e2e, (m["name"], cell)
    for w in bench["workloads"]:
        e2e = manifest.metrics_for(bench, w["name"], "end_to_end")
        assert "setup_s" in [x["name"] for x in e2e] and len(e2e) >= 2
        assert manifest.metrics_for(bench, w["name"], "per_layer")


def test_readers_find_nothing_in_an_empty_run():
    bench = _bench()
    for m in bench["per_layer"]:
        assert manifest.reader(m["name"])({}) is None


# -- what a run may load -------------------------------------------------------

def test_forbidden_modules_by_whole_top_level_name():
    assert guard.forbidden_modules(["oim_tpu_torch", "oim_tpu_torch.serve", "jaxtyping",
                                    "google", "google.auth", "grpcio_tools_x"]) == []
    assert guard.forbidden_modules(["oim_tpu", "oim_tpu.models", "jax.numpy", "jaxlib",
                                    "flax", "grpc", "google.protobuf.message"]) == sorted(
        ["oim_tpu", "oim_tpu.models", "jax.numpy", "jaxlib", "flax", "grpc",
         "google.protobuf.message"])


def test_the_harness_and_the_reference_load_no_jax():
    import subprocess
    code = ("import sys; import benchmark.run, benchmark.harness.serve, "
            "benchmark.harness.train, benchmark.harness.reference; "
            "from benchmark.harness import guard; print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(manifest.HERE.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    src = (manifest.HERE / "harness" / "reference.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+oim_tpu", src, re.M)


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mistral-7b.conv", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err


# -- the serving driver's readings from the program's calls and the stamps ---

def test_decode_steps_and_live_rows_from_the_token_stamps():
    from benchmark.harness import serve

    calls = [("decode", 0.0), ("decode", 1.0), ("prefill", 2.0), ("decode", 2.5),
             ("decode", 3.5)]
    assert serve.decode_steps(calls) == [(0.0, 1.0, True), (1.0, 2.0, False),
                                         (2.5, 3.5, True)]
    log = [  # stamps land just after each step's end
        {"prompt": [0] * 10, "times": [-0.2, 1.001, 2.001]},  # live in steps 0 and 1
        {"prompt": [0] * 4, "times": [2.3, 3.501]},  # prefilled at 2.0: live in step 2 only
        {"prompt": [0] * 7, "times": [-0.1, 1.002]},  # retires at step 0
    ]
    assert serve.live_contexts(log, 0.0, 1.0) == [11, 8]
    assert serve.live_contexts(log, 1.0, 2.0) == [12]
    assert serve.live_contexts(log, 2.5, 3.5) == [5]
