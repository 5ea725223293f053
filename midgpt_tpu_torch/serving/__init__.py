"""Serving: paged KV pool + continuous-batching engine.

- :class:`~midgpt_tpu_torch.serving.paged.PagedKVPool`,
  :class:`~midgpt_tpu_torch.serving.paged.PageAllocator`: the page pool
  and its host-side refcounting allocator.
- :class:`~midgpt_tpu_torch.serving.engine.ServingEngine`: ``submit()``
  requests, ``run()`` to drain.
- :func:`generate_served`: one-shot batch generation through the engine.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.serving.engine import (
    Request,
    ServingEngine,
    decode_window,
    prefill_chunk,
)
from midgpt_tpu_torch.serving.paged import (
    PageAllocator,
    PagedKVPool,
    flush_recent,
    pages_needed,
    write_token_rows,
)

__all__ = [
    "PageAllocator",
    "PagedKVPool",
    "Request",
    "ServingEngine",
    "decode_window",
    "flush_recent",
    "generate_served",
    "pages_needed",
    "prefill_chunk",
    "write_token_rows",
]


def generate_served(
    model,
    prompts: tp.Sequence[np.ndarray],
    max_new_tokens: int,
    *,
    eos_id: tp.Optional[int] = None,
    temperature: float = 0.0,
    top_k: tp.Optional[int] = None,
    slots: tp.Optional[int] = None,
    window: int = 4,
    page_size: int = 16,
    cache_dtype: tp.Optional[torch.dtype] = None,
    seed: int = 0,
    device: tp.Union[None, str, torch.device] = None,
) -> tp.List[np.ndarray]:
    """Submit every prompt (request seed = its index), drain the engine,
    and return the generated token arrays in submission order. Runs on
    the card unless ``device="cpu"``."""
    eng = ServingEngine(
        model,
        slots=slots if slots is not None else max(1, min(8, len(prompts))),
        page_size=page_size,
        window=window,
        temperature=temperature,
        top_k=top_k,
        cache_dtype=cache_dtype,
        seed=seed,
        device=device,
    )
    rids = [
        eng.submit(p, max_new_tokens, eos_id=eos_id, seed=i)
        for i, p in enumerate(prompts)
    ]
    finished = eng.run()
    return [np.asarray(finished[r].tokens, np.int32) for r in rids]
