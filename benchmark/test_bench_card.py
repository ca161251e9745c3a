"""The comparison's control at each cell's own size, on the card: a run
with ``--control`` must come out correct, and the fp8 control, held to
the cell's own limits by the run itself, must fail them
(``control_ok`` false). Skips where there is no CUDA device."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import manifest

SEED = 2**31 + 4242


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their real sizes on the card")


def _run(cell: str, seconds: int) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(SEED),
         "--seconds", str(seconds), "--trace", "0", "--control"],
        capture_output=True, text=True, cwd=str(manifest.HERE.parent), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell,seconds", [("mistral-7b.conv", 51), ("mistral-7b.code", 51),
                                          ("mixtral-8x7b-2l.train", 10)])
def test_control_fails_the_cells_limits(card, cell, seconds):
    res = _run(cell, seconds)
    assert res["correct"], res["check"]
    assert res["compared"]["control_ok"] is False, res["compared"]
