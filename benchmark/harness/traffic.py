"""The one traffic generator: it reads a mix's data file
(``benchmark/traffic/<name>.json``) and makes the requests of a run from
its seed.

Lengths are drawn from the mix's distributions by stratified quantiles:
a block of ``block`` strata, the distribution's quantiles at
(i + 0.5) / block, rounded and clipped. The requests walk the strata in a
fixed low-discrepancy order (a Halton sequence: the prompt's stratum by
the base-2 radical inverse of the request's index, the output's by the
base-3 one), so any run of consecutive requests covers both
distributions nearly evenly, and every ``block`` requests hold each
prompt and each output length once. The run's seed picks where in that
cycle the run starts and draws the token ids. So two seeds do the same
work in another order, and a window sees nearly the same mix whichever
requests fall in it.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


def load(name: str, root: Path = TRAFFIC_DIR) -> dict:
    path = root / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def _seed_words(seed: int) -> list[int]:
    """A seed of any size as the non-negative words numpy's SeedSequence
    takes (a negative seed maps to its two's complement in 64 bits)."""
    seed = int(seed) % (1 << 64)
    return [seed & 0xFFFFFFFF, seed >> 32]


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the stratified quantiles (i + 0.5) / n of the
    distribution ``spec`` ({"dist": "lognormal", "median", "sigma", "min",
    "max"}), rounded and clipped, ascending."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = statistics.NormalDist()
    mu = math.log(spec["median"])
    xs = [math.exp(mu + spec["sigma"] * z.inv_cdf((i + 0.5) / n)) for i in range(n)]
    out = np.clip(np.rint(xs), spec["min"], spec["max"]).astype(np.int64)
    return out


def radical_inverse(i: int, base: int) -> float:
    out, f = 0.0, 1.0 / base
    while i:
        out += f * (i % base)
        i //= base
        f /= base
    return out


def halton_ranks(n: int, base: int) -> np.ndarray:
    """The stratum (0 = shortest) of each of the first ``n`` indices: the
    rank of its base-``base`` radical inverse among them."""
    return np.argsort(np.argsort([radical_inverse(i, base) for i in range(n)]))


def block_lengths(mix: dict) -> tuple[np.ndarray, np.ndarray]:
    """The (prompt, output) lengths of one cycle of ``block`` requests, in
    the order the requests take them."""
    n = int(mix["block"])
    prompt = quantile_lengths(mix["prompt"], n)
    output = quantile_lengths(mix["output"], n)
    return prompt[halton_ranks(n, 2)], output[halton_ranks(n, 3)]


class Requests:
    """The run's request sequence: ``lengths(i)`` and ``tokens(i)`` of the
    i-th request sent, for any i (the cycle repeats)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.block = int(mix["block"])
        self.prompt, self.output = block_lengths(mix)
        self.offset = int(np.random.default_rng(_seed_words(self.seed) + [0]).integers(self.block))

    def lengths(self, i: int) -> tuple[int, int]:
        j = (i + self.offset) % self.block
        return int(self.prompt[j]), int(self.output[j])

    def tokens(self, i: int) -> list[int]:
        n, _ = self.lengths(i)
        rng = np.random.default_rng(_seed_words(self.seed) + [1, i])
        return rng.integers(0, self.vocab, n).tolist()

    def max_prompt(self) -> int:
        return int(self.prompt.max())
