"""The drivers end to end at a tiny size on the CPU, against the plain
reference: sound runs come out correct, the fp8 control reads far above
them, and each fault a cell can have turns ``correct`` false. The look
for a chip is skipped (the drivers take the device); the rest of a run is
the benchmark's own."""

from __future__ import annotations

import time

import pytest

from benchmark.harness import manifest, serve, train

LLAMA = manifest.family("llama")
TINY = dict(vocab=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
            rope_theta=1e6, norm_eps=1e-6, dtype="float32")
SERVE_MIX = {"name": "tiny", "kind": "serve", "clients": 4, "at_close": "first_token",
             "engine": {"max_batch": 4, "max_seq": 96},
             "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.8, "min": 4, "max": 64},
             "output": {"dist": "lognormal", "median": 8, "sigma": 1.0, "min": 1, "max": 30},
             "block": 16, "temperature": 0.0}
SERVE_LIMITS = {"max_logit_gap": 1e-3,
                "sample": {"min_served_tokens": 24, "max_requests": 6,
                           "max_reference_tokens": 2000}}
TRAIN_MIX = {"name": "tiny", "kind": "train", "batch": 2, "seq": 64, "volume_mib": 1,
             "optimizer": {"lr": 3e-4, "warmup_steps": 0, "total_steps": 10000,
                           "weight_decay": 0.1}, "log_every": 10}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "grad_diff": 1e-3, "change_gap": 1e-2}


def _serve(fault=None, control=False, seed=2**31 + 7):
    d = LLAMA.Dims(name="tiny", mlp_dim=192, **TINY)
    return serve.run({"name": "tiny"}, LLAMA, d, SERVE_MIX, SERVE_LIMITS, seed, 3.0, False, "cpu",
                     time.monotonic(), fault=fault, control=control)


def _train(fault=None, control=False, seed=2**31 + 7):
    d = LLAMA.Dims(name="tiny", mlp_dim=96, n_experts=4, top_k=2, aux_weight=0.02,
                   capacity_factor=1.25, vocab_chunk=64, **TINY)
    return train.run({"name": "tiny"}, LLAMA, d, TRAIN_MIX, TRAIN_LIMITS, seed, 0.5, False, "cpu",
                     time.monotonic(), fault=fault, control=control)


def test_serving_agrees_with_the_reference_and_the_control_does_not():
    res = _serve(control=True)
    check = res["check"]
    assert check["ok"] and res["failed"] == 0 and res["attempted"] > 0
    assert check["tokens_compared"] >= SERVE_LIMITS["sample"]["min_served_tokens"]
    assert check["max_logit_gap"]["value"] <= SERVE_LIMITS["max_logit_gap"]
    assert check["control_max_logit_gap"] > 3 * SERVE_LIMITS["max_logit_gap"]
    assert check["control_ok"] is False
    e2e = res["e2e"]
    assert e2e["output_tokens_per_s"] > 0 and e2e["itl_p95_ms"] > 0 and e2e["ttft_p95_ms"] > 0


def test_serving_fault_token_altered_is_caught():
    assert not _serve(fault="token")["check"]["ok"]


def test_training_agrees_with_the_reference_and_the_control_does_not():
    res = _train(control=True)
    check = res["check"]
    assert check["ok"], check
    for k, lim in TRAIN_LIMITS.items():
        assert check[k]["value"] <= lim
    assert any(check["control"][k] > 3 * lim for k, lim in TRAIN_LIMITS.items())
    assert check["control_ok"] is False
    assert res["e2e"]["train_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
def test_training_faults_are_caught(fault):
    assert not _train(fault=fault)["check"]["ok"]
