"""Sampling command line of the port (counterpart of the JAX package's
root ``sample.py``).

    python -m midgpt_tpu_torch.sample --ckpt_dir R [--start TEXT | FILE:path]
        [--num_samples 3] [--max_new_tokens 200] [--temperature 0.8]
        [--top_k K] [--seed 0] [--chunk_len 64] [--quant int8]
        [--serve [--serve_window 8] [--serve_page_size 16]
                 [--serve_prefill_chunk N] [--serve_spec N]
                 [--serve_tp N] [--no_prefix_cache] [--eos_id ID]]
        [--device cuda|cpu]

Reads ``R/config.json`` (written by ``midgpt_tpu_torch.launch``) and the
newest checkpoint's parameters from ``R/checkpoints`` (memory-mapped: the
Adam moments are never read, let alone moved to the card), casts the
model to bf16 (``--quant int8``: then to int8 weights), and samples
``--num_samples`` rows of the prompt with the fixed-batch sampler
(``sampling.make_sampler``, whose sliding window goes past
``block_size``) or, with ``--serve``, through the serving engine
(``serving.generate_served``, one request per sample, context capped at
``block_size``). Each sample prints as a row of dashes, then the prompt
and the sample. Runs on the card unless ``--device cpu``; with no card it
raises. ``--serve_tp N`` serves under a tensor-only mesh of N ranks
(column- and row-parallel weights, the KV pool split by whole KV heads,
vocabulary-sharded logits): in one process on the one device, every
rank a virtual one of a loopback mesh (``serving_meshes(N,
loopback=True)``); 1 or none is the single-card engine. Left out: the
JAX package's default of the config's own mesh (that needs a card a
rank) and its pre-quantized ``params_q8`` checkpoint item.

The tokenizer is the reference's: the data directory's ``meta.pkl``
character map, else tiktoken's GPT-2 encoding when its files are already
cached on this machine (never downloaded), else token ids separated by
spaces.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import tempfile
import typing as tp

# tiktoken's GPT-2 files, which it caches under the sha1 of their URL
_GPT2_FILES = tuple(
    "https://openaipublic.blob.core.windows.net/gpt-2/encodings/main/" + f
    for f in ("vocab.bpe", "encoder.json"))


def load_run_config(ckpt_dir: str):
    """The run's ``ExperimentConfig`` from ``<ckpt_dir>/config.json``."""
    from midgpt_tpu_torch.config import from_dict

    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return from_dict(json.load(f))


def _tiktoken_gpt2():
    """tiktoken's GPT-2 encoding if tiktoken is installed and its files
    sit in its cache; None otherwise, so nothing is ever fetched."""
    try:
        import tiktoken
    except ImportError:
        return None
    cache = os.environ.get("TIKTOKEN_CACHE_DIR") or os.environ.get(
        "DATA_GYM_CACHE_DIR") or os.path.join(tempfile.gettempdir(),
                                              "data-gym-cache")
    if not all(os.path.exists(os.path.join(
            cache, hashlib.sha1(url.encode()).hexdigest()))
            for url in _GPT2_FILES):
        return None
    return tiktoken.get_encoding("gpt2")


def get_tokenizer(data_dir: str) -> tp.Tuple[tp.Callable, tp.Callable]:
    """``(encode, decode)``: ``meta.pkl``'s character map, else GPT-2's
    BPE, else token ids."""
    meta_path = os.path.join(data_dir, "meta.pkl") if data_dir else ""
    if meta_path and os.path.exists(meta_path):
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)
        stoi, itos = meta["stoi"], meta["itos"]
        # a vocabulary padded past the charset can emit unmapped ids
        return (lambda s: [stoi[c] for c in s],
                lambda ids: "".join(itos.get(int(i), "�") for i in ids))
    enc = _tiktoken_gpt2()
    if enc is not None:
        return (lambda s: enc.encode(s, allowed_special={"<|endoftext|>"}),
                lambda ids: enc.decode([int(i) for i in ids]))
    return (lambda s: [int(tok) for tok in s.split()],
            lambda ids: " ".join(str(int(i)) for i in ids))


def restore_model(ckpt_dir: str, cfg, device):
    """``(model, step)``: the newest checkpoint's parameters in a bf16
    model on ``device``, as the JAX sampler casts its restored params."""
    import torch

    from midgpt_tpu_torch.checkpoint import Checkpointer
    from midgpt_tpu_torch.models.gpt import GPT

    items, meta = Checkpointer(ckpt_dir).restore(map_location="cpu")
    with torch.device("meta"):  # shapes only: no random draw
        model = GPT.init(cfg.model, device="meta")
    model.load_state_dict(items["params"], assign=True)
    return model.to(device=device, dtype=torch.bfloat16), meta["step"]


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return n


def main(argv: tp.Optional[tp.Sequence[str]] = None):
    """Print the samples; returns them as token arrays."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--start", default="\n", help='prompt text or "FILE:path"')
    ap.add_argument("--num_samples", type=int, default=3)
    ap.add_argument("--max_new_tokens", type=int, default=200)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top_k", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk_len", type=_positive_int, default=64,
                    help="decode chunk length of the fixed-batch sampler "
                    "(recent-row buffer; speed only)")
    ap.add_argument("--serve", action="store_true",
                    help="generate through the serving engine: paged KV, "
                    "continuous batching, one request per sample, early "
                    "exit at --eos_id; context capped at block_size")
    ap.add_argument("--serve_window", type=_positive_int, default=8,
                    help="decode steps per window in --serve mode")
    ap.add_argument("--serve_page_size", type=_positive_int, default=16,
                    help="KV page size (tokens) in --serve mode")
    ap.add_argument("--serve_prefill_chunk", type=_positive_int,
                    default=None, help="chunked-prefill chunk (tokens) in "
                    "--serve mode; default one pass")
    ap.add_argument("--serve_spec", type=_positive_int, default=None,
                    help="self-speculative draft length in --serve mode")
    ap.add_argument("--serve_tp", type=_positive_int, default=None,
                    help="tensor-parallel degree in --serve mode: the "
                    "engine on a tensor-only mesh of N ranks, held as a "
                    "loopback on the one device (1 or none: one card's "
                    "engine)")
    ap.add_argument("--no_prefix_cache", action="store_true",
                    help="turn the prefix cache off in --serve mode")
    ap.add_argument("--quant", choices=("int8",), default=None,
                    help="int8 per-channel weights (quant.quantize_model "
                    "of the bf16 model)")
    ap.add_argument("--eos_id", type=int, default=None,
                    help="stop a request at this token id (--serve mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from midgpt_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = load_run_config(args.ckpt_dir)
    model, step = restore_model(args.ckpt_dir, cfg, device)
    print(f"restored step {step} from {args.ckpt_dir}")
    if args.quant:
        from midgpt_tpu_torch.quant import quantize_model

        model = quantize_model(model)

    encode, decode = get_tokenizer(cfg.data_dir)
    start = args.start
    if start.startswith("FILE:"):
        with open(start[5:]) as f:
            start = f.read()
    prompt = np.tile(np.asarray(encode(start), np.int32)[None],
                     (args.num_samples, 1))
    if args.serve:
        from midgpt_tpu_torch.serving import generate_served, serving_meshes

        mesh = serving_meshes(args.serve_tp or 1, devices=[device],
                              loopback=True)[0]
        outs = generate_served(
            model, list(prompt), args.max_new_tokens, eos_id=args.eos_id,
            temperature=args.temperature, top_k=args.top_k,
            window=args.serve_window, page_size=args.serve_page_size,
            prefix_cache=not args.no_prefix_cache,
            prefill_chunk=args.serve_prefill_chunk,
            speculate=args.serve_spec or 0, seed=args.seed, device=device,
            mesh=mesh)
    else:
        from midgpt_tpu_torch.sampling import make_sampler

        sampler = make_sampler(args.max_new_tokens,
                               temperature=args.temperature,
                               top_k=args.top_k, chunk_len=args.chunk_len,
                               device=device)
        outs = list(sampler(model, prompt, args.seed).cpu().numpy())
    for toks in outs:
        print("-" * 40)
        print(start + decode(toks))
    return outs


if __name__ == "__main__":
    main()
