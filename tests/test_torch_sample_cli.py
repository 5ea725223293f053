"""The port's sample command line (``python -m midgpt_tpu_torch.sample``)
and its config loader, on the CPU.

A two-step run of ``tiny`` trained with the port's ``launch`` gives the
checkpoint. Prompts are token ids (no tokenizer files exist here; the
tiktoken cache is pointed at an empty directory so nothing is fetched).
Each CLI mode prints what a direct call on the restored bf16 model gives:
the fixed-batch sampler past ``block_size`` (its sliding window),
``--serve`` (``generate_served``), ``--quant int8`` in both; a sampled run
repeats itself. ``config.from_dict`` inverts ``to_dict`` for every named
config and names an unknown key.
"""

import json
import os

import numpy as np
import pytest
import torch

from midgpt_tpu_torch import sample
from midgpt_tpu_torch.config import (
    MODEL_CONFIGS,
    ExperimentConfig,
    from_dict,
    get_config,
    to_dict,
)
from midgpt_tpu_torch.data import write_tokens
from midgpt_tpu_torch.quant import quantize_model
from midgpt_tpu_torch.sampling import make_sampler
from midgpt_tpu_torch.serving import generate_served

torch.set_num_threads(2)

START = "1 2 3 4 5 "


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from midgpt_tpu_torch.launch import main

    root = tmp_path_factory.mktemp("sample_cli")
    data = root / "data"
    rng = np.random.default_rng(0)
    write_tokens(str(data / "train.bin"), np.tile(np.arange(64), 200))
    write_tokens(str(data / "val.bin"), rng.integers(0, 64, 3000))
    run = str(root / "run")
    main(["--config", "tiny", "--rundir", run, "--set", f"data_dir={data}",
          "device=cpu", "max_steps=2", "eval_batches=1"])
    return run


@pytest.fixture(autouse=True)
def _no_tokenizer_files(tmp_path, monkeypatch):
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(tmp_path / "no_cache"))


def _cli(run_dir, capsys, *extra):
    outs = sample.main(["--ckpt_dir", run_dir, "--device", "cpu", "--start",
                        START, "--num_samples", "2", *extra])
    return outs, capsys.readouterr().out.splitlines()


def _expected_lines(outs):
    _, decode = sample.get_tokenizer("")
    lines = []
    for toks in outs:
        lines += ["-" * 40, START + decode(toks)]
    return lines


def _direct(run_dir, quant=False):
    cfg = sample.load_run_config(run_dir)
    model, _ = sample.restore_model(run_dir, cfg, torch.device("cpu"))
    assert model.dtype == torch.bfloat16
    prompt = np.tile(np.arange(1, 6, dtype=np.int32)[None], (2, 1))
    return (quantize_model(model) if quant else model), prompt


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_fixed_batch_cli_prints_the_samplers_tokens(run_dir, capsys, quant):
    """70 new tokens after 5: past tiny's block_size of 64, so the exact
    sliding window runs too."""
    extra = ["--quant", "int8"] if quant else []
    outs, lines = _cli(run_dir, capsys, "--max_new_tokens", "70",
                       "--temperature", "0", *extra)
    model, prompt = _direct(run_dir, quant)
    ref = make_sampler(70, temperature=0.0, device="cpu")(model, prompt, 0)
    np.testing.assert_array_equal(np.stack(outs), ref.numpy())
    assert lines[0] == f"restored step 1 from {run_dir}"
    assert lines[1:] == _expected_lines(ref.numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_serve_cli_prints_generate_served_tokens(run_dir, capsys, quant):
    extra = ["--quant", "int8"] if quant else []
    outs, lines = _cli(run_dir, capsys, "--serve", "--max_new_tokens", "24",
                       "--temperature", "0", *extra)
    model, prompt = _direct(run_dir, quant)
    ref = generate_served(model, list(prompt), 24, window=8, page_size=16,
                          device="cpu")
    np.testing.assert_array_equal(np.stack(outs), np.stack(ref))
    assert lines[1:] == _expected_lines(ref)


@pytest.mark.parametrize("mode", [[], ["--serve"]], ids=["fixed", "serve"])
def test_sampled_cli_repeats_itself(run_dir, capsys, mode):
    args = ["--max_new_tokens", "20", "--temperature", "0.8", "--top_k", "5",
            "--seed", "3", *mode]
    a, lines_a = _cli(run_dir, capsys, *args)
    b, lines_b = _cli(run_dir, capsys, *args)
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    assert lines_a == lines_b and len(lines_a) == 5
    assert all(len(t) == 20 for t in a)


def test_config_round_trips_and_names_unknown_keys(run_dir):
    named = [get_config(n) for n in ("openwebtext", "openwebtext_moe",
                                     "shakespeare_char", "tiny")]
    named += [ExperimentConfig(model=m) for m in MODEL_CONFIGS.values()]
    for cfg in named:
        assert from_dict(json.loads(json.dumps(to_dict(cfg)))) == cfg
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    cfg = from_dict(saved)
    assert (cfg.device, cfg.max_steps, cfg.model) == (
        "cpu", 2, MODEL_CONFIGS["tiny"])
    with pytest.raises(ValueError, match="'use_wandb'"):
        from_dict(dict(saved, use_wandb=True))
    with pytest.raises(ValueError, match="'layer_scan'"):
        from_dict(dict(saved, model=dict(saved["model"], layer_scan="on")))
