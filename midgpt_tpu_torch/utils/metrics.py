"""Training throughput, MFU and a JSONL metric log (counterpart of
``midgpt_tpu.utils.metrics``; no wandb).

``flops_per_token`` is the JAX package's model-FLOPs count (6 N for the
matmuls incl. the lm head, plus the causal attention term). The card's
peak is looked up by its name: published dense bf16 rates.
"""

from __future__ import annotations

import json
import os
import time
import typing as tp

from midgpt_tpu_torch.config import ExperimentConfig, ModelConfig, to_dict

# dense bf16 peak FLOP/s by device-name substring (NVIDIA data sheets)
_PEAK_FLOPS = {
    "H100": 989e12,
    "H200": 989e12,
}


def device_peak_flops(device_name: str) -> float:
    """The card's dense bf16 peak; raises for a card not in the table."""
    for key, val in _PEAK_FLOPS.items():
        if key in device_name:
            return val
    raise KeyError(f"no peak FLOP/s known for device {device_name!r}")


def flops_per_token(model: ModelConfig,
                    seq_len: tp.Optional[int] = None) -> float:
    """Training FLOPs/token (fwd+bwd), PaLM-style 6N + attention term."""
    from midgpt_tpu_torch.models.gpt import mlp_hidden_dim

    t = seq_len or model.block_size
    d, c = model.n_embd, model.head_dim
    f = mlp_hidden_dim(model)
    qkv = d * (model.n_head + 2 * model.kv_heads) * c
    proj = model.n_head * c * d
    mlp = (3 if model.mlp == "swiglu" else 2) * d * f
    # + the lm-head projection; the embedding is a gather
    n_matmul = model.n_layer * (qkv + proj + mlp) + d * model.vocab_size
    attn = 6 * 2 * model.n_layer * model.n_head * c * t / 2  # causal
    return 6 * n_matmul + attn


def mfu(tokens_per_sec: float, model: ModelConfig, device_name: str,
        n_devices: int = 1) -> float:
    return (tokens_per_sec * flops_per_token(model)
            / (device_peak_flops(device_name) * n_devices))


class MetricLogger:
    """Appends ``{"step": s, "time": t, **metrics}`` rows to
    ``<rundir>/metrics.jsonl``."""

    def __init__(self, rundir: str, cfg: tp.Optional[ExperimentConfig] = None):
        os.makedirs(rundir, exist_ok=True)
        self.path = os.path.join(rundir, "metrics.jsonl")
        self._f = open(self.path, "a")
        if cfg is not None:
            self._write({"config": to_dict(cfg)})

    def _write(self, row: tp.Mapping[str, tp.Any]) -> None:
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def log(self, step: int, metrics: tp.Mapping[str, float]) -> None:
        self._write({"step": step, "time": time.time(), **metrics})

    def close(self) -> None:
        self._f.close()


def read_metrics(rundir: str) -> tp.List[tp.Dict[str, tp.Any]]:
    """The logged step rows of a run, in order."""
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if "step" in r]
