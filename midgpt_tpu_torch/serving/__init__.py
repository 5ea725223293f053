"""Serving: paged KV pool + continuous-batching engine.

- :class:`~midgpt_tpu_torch.serving.paged.PagedKVPool`,
  :class:`~midgpt_tpu_torch.serving.paged.PageAllocator`: the page pool
  and its host-side refcounting allocator.
- :class:`~midgpt_tpu_torch.serving.engine.ServingEngine`: ``submit()``
  requests, ``run()`` to drain.
- :func:`generate_served`: one-shot batch generation through the engine.
- :class:`~midgpt_tpu_torch.serving.speculate.NgramProposer`: the
  drafts of self-speculative decoding (``speculate=N``), verified by
  :func:`~midgpt_tpu_torch.serving.engine.verify_dispatch`.
- int8 serving: ``quant="int8"`` (weights) and ``kv_quant="int8"`` (the
  pool, with :func:`~midgpt_tpu_torch.serving.paged.kv_row_scales`).
- the prefix cache: :class:`~midgpt_tpu_torch.serving.paged.PrefixIndex`
  and :func:`~midgpt_tpu_torch.serving.paged.copy_page`; chunked prefill
  (``prefill_chunk``, ``prefill_budget``).
- the request lifecycle under load: eviction and parking, priorities,
  deadlines, ``cancel``, ``lookup``, ``drain_requests``/``resubmit``, the
  typed failures and the scripted :class:`~midgpt_tpu_torch.serving.
  faults.FaultPlan` (``serving.faults``).
- cold-page host spill (``spill="on"``):
  :class:`~midgpt_tpu_torch.serving.paged.HostSpillStore`,
  :func:`~midgpt_tpu_torch.serving.paged.export_pages` and
  :func:`~midgpt_tpu_torch.serving.paged.import_pages`.
- metrics and tracing: :class:`~midgpt_tpu_torch.serving.telemetry.
  EngineTelemetry`, :data:`ENGINE_STATS_KEYS`, :data:`EVENT_KINDS`,
  :func:`chrome_trace` (``serving.telemetry``).
- the async front door: :class:`~midgpt_tpu_torch.serving.frontdoor.
  AsyncFrontDoor`, :class:`TokenStream`, :class:`VirtualClock`, over an
  engine or a cluster.
- the shared-nothing cluster: :class:`~midgpt_tpu_torch.serving.
  cluster.ServingCluster` (``replicas=N`` engines on one card, or
  ``meshes=serving_meshes(tp, dp, loopback=True)``: tensor-parallel
  replicas on one card; several cards wait for ROADMAP A5; least-loaded or
  prefix-affinity admission, health, retries, warm and cold failover,
  flight dumps of dead replicas); disaggregated prefill and decode pools
  (``prefill_replicas=P, decode_replicas=D``) that move a prefilled
  request between engines as a :class:`~midgpt_tpu_torch.serving.engine.
  HandoffRecord` (``ServingEngine.export_request`` /
  ``import_request``); its stats keys :data:`CLUSTER_STATS_KEYS`.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.serving.cluster import (
    ServingCluster,
    serving_devices,
    serving_meshes,
)
from midgpt_tpu_torch.serving.engine import (
    HandoffRecord,
    Request,
    ServingEngine,
    decode_window,
    prefill_chunk,
    verify_dispatch,
)
from midgpt_tpu_torch.serving.faults import (
    AdmissionRejected,
    Cancelled,
    ClusterUnavailable,
    DeadlineExceeded,
    FaultEvent,
    FaultPlan,
    HandoffFailed,
    PoolOverloaded,
    ReplicaCrash,
    ServingFault,
    TransientDispatchError,
    WedgedDispatch,
)
from midgpt_tpu_torch.serving.frontdoor import (
    AsyncFrontDoor,
    TokenStream,
    VirtualClock,
)
from midgpt_tpu_torch.serving.paged import (
    HostSpillStore,
    PageAllocator,
    PagedKVPool,
    PrefixIndex,
    copy_page,
    export_pages,
    flush_recent,
    import_pages,
    kv_row_scales,
    pages_needed,
    write_token_rows,
)
from midgpt_tpu_torch.serving.speculate import (
    NgramProposer,
    Proposer,
    SoftProposer,
)
from midgpt_tpu_torch.serving.telemetry import (
    CLUSTER_STATS_KEYS,
    ENGINE_STATS_KEYS,
    EVENT_KINDS,
    EngineTelemetry,
    MetricsRegistry,
    chrome_trace,
)

__all__ = [
    "AdmissionRejected",
    "AsyncFrontDoor",
    "CLUSTER_STATS_KEYS",
    "Cancelled",
    "ClusterUnavailable",
    "DeadlineExceeded",
    "ENGINE_STATS_KEYS",
    "EVENT_KINDS",
    "EngineTelemetry",
    "FaultEvent",
    "FaultPlan",
    "HandoffFailed",
    "HandoffRecord",
    "HostSpillStore",
    "MetricsRegistry",
    "NgramProposer",
    "PoolOverloaded",
    "ReplicaCrash",
    "ServingFault",
    "TransientDispatchError",
    "WedgedDispatch",
    "PageAllocator",
    "PagedKVPool",
    "PrefixIndex",
    "Request",
    "ServingCluster",
    "ServingEngine",
    "TokenStream",
    "VirtualClock",
    "chrome_trace",
    "decode_window",
    "export_pages",
    "flush_recent",
    "copy_page",
    "generate_served",
    "import_pages",
    "kv_row_scales",
    "pages_needed",
    "prefill_chunk",
    "serving_devices",
    "serving_meshes",
    "Proposer",
    "SoftProposer",
    "verify_dispatch",
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
    speculate: int = 0,
    proposer: tp.Optional[Proposer] = None,
    quant: tp.Optional[str] = None,
    kv_quant: tp.Optional[str] = None,
    prefix_cache: bool = True,
    prefill_chunk: tp.Optional[int] = None,
    prefill_budget: tp.Optional[int] = None,
    max_prefills_per_window: tp.Optional[int] = None,
    mesh=None,
) -> tp.List[np.ndarray]:
    """Submit every prompt (request seed = its index), drain the engine,
    and return the generated token arrays in submission order. Runs on
    the card unless ``device="cpu"``; ``speculate=N`` verifies up to N
    drafted tokens per slot and dispatch; ``quant="int8"`` serves int8
    weights and ``kv_quant="int8"`` an int8 KV pool; ``prefix_cache``,
    ``prefill_chunk``, ``prefill_budget``, ``max_prefills_per_window``
    and ``mesh`` (a tensor-only serving mesh, JAX's) as
    :class:`ServingEngine` takes them."""
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
        speculate=speculate,
        proposer=proposer,
        quant=quant,
        kv_quant=kv_quant,
        prefix_cache=prefix_cache,
        prefill_chunk=prefill_chunk,
        prefill_budget=prefill_budget,
        max_prefills_per_window=max_prefills_per_window,
        mesh=mesh,
    )
    rids = [
        eng.submit(p, max_new_tokens, eos_id=eos_id, seed=i)
        for i, p in enumerate(prompts)
    ]
    finished = eng.run()
    return [np.asarray(finished[r].tokens, np.int32) for r in rids]
