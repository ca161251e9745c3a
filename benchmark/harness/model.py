"""A configuration file (``benchmark/configs/<name>.json``) read into the
sizes the harness, the reference and the counts of operations use.

The file keeps the published ``config.json``'s keys and values, changed
only where ``reduced`` says; ``run`` holds what the published file does
not state and the run needs (the serving dtype, the capacity factor, the
loss's vocabulary chunk), each listed under ``assumed`` too."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    mlp_dim: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0
    aux_weight: float = 0.0
    capacity_factor: float = 0.0
    vocab_chunk: int = 0
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def load(name: str, path: Path | None = None) -> dict:
    path = CONFIG_DIR / f"{name}.json" if path is None else Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} at {path}")
    return json.loads(path.read_text())


def dims(conf: dict) -> Dims:
    """The sizes of a configuration file."""
    run = conf.get("run", {})
    heads = conf["num_attention_heads"]
    return Dims(
        name=conf["name"],
        vocab=conf["vocab_size"],
        dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"],
        n_heads=heads,
        n_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
        mlp_dim=conf["intermediate_size"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        n_experts=conf.get("num_local_experts", 0),
        top_k=conf.get("num_experts_per_tok", 0),
        aux_weight=float(conf.get("router_aux_loss_coef", 0.0)),
        capacity_factor=float(run.get("moe_capacity_factor", 0.0)),
        vocab_chunk=int(run.get("vocab_chunk", 0)),
        dtype=run.get("dtype", conf.get("torch_dtype", "bfloat16")),
    )
