"""The port stands alone: no JAX, nothing of ``midgpt_tpu``, CUDA by default.

- every module of ``midgpt_tpu_torch`` imports in a process where
  ``jax`` cannot be imported;
- no source file of the package, nor ``chip_smoke.py`` or
  ``chip_turns.py``, imports ``jax``
  or ``midgpt_tpu`` (an AST scan; ``midgpt_tpu_torch`` itself is fine);
- the entry points default to the card and raise without one, unless the
  caller passes ``device="cpu"``.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import midgpt_tpu_torch
from midgpt_tpu_torch.config import get_model_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "midgpt_tpu_torch")

torch.set_num_threads(2)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="midgpt_tpu_torch.")
    )


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    for m in ("ops.paged_attn", "ops.fused_attn", "ops.fused_norm",
              "ops.attention", "ops.loss", "train", "data", "checkpoint",
              "launch",
              "utils.metrics", "serving.speculate", "serving.engine",
              "quant"):
        assert f"midgpt_tpu_torch.{m}" in mods, m
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['midgpt_tpu'] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'midgpt_tpu' or m.startswith('midgpt_tpu.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_turns.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "midgpt_tpu")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_default_to_cuda(monkeypatch):
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.serving import ServingEngine, generate_served

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_model_config("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT.init(cfg)
    model = GPT.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_served(model, [[1, 2, 3]], 2)
    assert ServingEngine(model, device="cpu").device.type == "cpu"


def test_train_defaults_to_cuda(monkeypatch, tmp_path):
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.train import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny", rundir=str(tmp_path))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg)


def test_registry_holds_the_reference_configs():
    owt = get_model_config("openwebtext")
    assert (owt.block_size, owt.vocab_size, owt.n_layer, owt.n_head,
            owt.n_embd, owt.head_dim, owt.kv_heads) == (
        1024, 50304, 12, 12, 768, 64, 12)
    assert owt.mlp == "gelu" and owt.qk_norm and not owt.tie_embeddings
    llama = get_model_config("llama_7b")
    assert (llama.kv_heads, llama.head_dim, llama.mlp) == (8, 128, "swiglu")
    assert set(midgpt_tpu_torch.MODEL_CONFIGS) == {
        "openwebtext", "tiny", "shakespeare_char", "llama_7b"}
    with pytest.raises(KeyError):
        get_model_config("gpt5")


def test_model_configs_match_the_jax_registry():
    """The copy agrees with the JAX package's named configs field by field
    (only the test imports both)."""
    import dataclasses

    import midgpt_tpu.configs  # noqa: F401  registers the named configs
    from midgpt_tpu.config import get_config

    for name, cfg in midgpt_tpu_torch.MODEL_CONFIGS.items():
        ref = get_config(name).model
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(ref, f.name), (name, f.name)
