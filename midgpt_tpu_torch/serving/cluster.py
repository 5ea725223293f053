"""Shared-nothing serving over engine replicas, with failover (counterpart
of ``midgpt_tpu.serving.cluster``).

A :class:`ServingCluster` is N complete
:class:`~midgpt_tpu_torch.serving.engine.ServingEngine` replicas, each
with its own page pool, prefix cache and scheduler, under one admission
scheduler. Nothing is shared between replicas but the model's weights,
so a replica's failure touches only its own requests.

- **Least-loaded admission**: ``submit`` routes a request to the live
  replica with the fewest queued, parked and running requests, the
  lowest index on a tie. A stream is a function of its request alone, so
  placement changes latency, never tokens. A full queue (``queue_full``)
  spills over to the next replica in load order.
- **Health and failover**: each replica is ``healthy``, ``suspect`` or
  ``dead``. A :class:`~midgpt_tpu_torch.serving.faults.
  TransientDispatchError` is retried on the same replica with capped
  exponential backoff (suspect meanwhile); a crash, a wedge, a
  watchdog trip (``dispatch_timeout_s``: the step's worker thread still
  running at the deadline) or exhausted retries mark it dead and move
  its requests to the survivors: warm (the engine drains, progress
  kept) when its step ended by raising, cold (served again from the
  cluster's submission record, the engine never touched again) after a
  watchdog trip. Failures are handled only once every replica's step
  has settled, so no engine is changed during its own step.
- **Prefix affinity** (``affinity=True``): admission probes each
  candidate's :class:`~midgpt_tpu_torch.serving.paged.PrefixIndex`
  (``match`` reads only) and prefers the longest resident prefix within
  ``affinity_max_imbalance`` requests of the least load; no overlap falls
  back to least-loaded.
- **Disaggregated pools** (``prefill_replicas=P, decode_replicas=D``):
  the first P replicas are ``role="prefill"`` engines, the next D
  ``role="decode"``. After each round the cluster pumps handoffs: a
  handoff-ready slot leaves its prefill replica as a
  :class:`~midgpt_tpu_torch.serving.engine.HandoffRecord` (host copies
  queued on the source's stream) and lands in the least-loaded live
  decode replica, which aliases the prefix its own index holds. A
  scripted ``handoff`` fault fails the export before anything leaves the
  slot, and the request is served again cold. Admission and failover
  target the prefill pool, and any live replica once the whole prefill
  pool is dead.
- **Stats**: :meth:`ServingCluster.stats` sums the engines' counters in
  ``ServingEngine.stats``' layout (rates averaged) and adds the cluster's
  own, exactly the keys of
  :data:`~midgpt_tpu_torch.serving.telemetry.CLUSTER_STATS_KEYS`.

On one card ``replicas=N`` puts N engines on the caller's device (JAX's
``meshes=None``); ``devices=`` (:func:`serving_devices`) names that
device per replica, and ``meshes=`` (:func:`serving_meshes`) gives each
replica its tensor-only serving mesh, a TP x DP deployment: on one card
every replica's tensor ranks run on a loopback
(``serving_meshes(..., loopback=True)``), the model sharded once and
shared by the replicas of one mesh size (``models.gpt.tensor_copy``).
More than one distinct device, or a mesh over a process group, raises
``NotImplementedError`` (ROADMAP A5: replicas over several cards wait
for a second card to run on). Replicas step in turn on the scheduler's
thread: they share the stream current where they were built (the paged
kernel's scratch is kept per device, not per stream), so threads would
overlap no device work, and their hand-offs of the GIL cost more than
the host work they overlap. Under a watchdog every replica steps on a
worker thread, which enters its engine's stream, so that a wedged step
can be abandoned.

Each replica's engine owns its one-dispatch programs (CUDA graphs on the
card, ``serving.programs``) and captures them at its first decode window
or verify dispatch and each prefill bucket at its first chunk (nothing
here calls ``warm_prefill``), wherever it steps, so captures run while
the other replicas serve: a capture on a worker thread runs in
``capture_error_mode="thread_local"`` under the programs' process-wide
capture lock, so the other replicas' workers go on queueing, allocating
and waiting on the card meanwhile. What a capture still forbids to every
other thread of the process: synchronizing the device, and drawing from
the default CUDA generator (``torch.randn(..., device="cuda")`` with no
``generator=`` raises "Offset increment outside graph capture"). Code
that shares the process with a serving cluster draws from a generator
of its own and waits on its own stream or events. Failover moves requests to the live
replicas, whose programs are already captured; a dead replica's
programs, like its pool, are freed with its engine when the cluster is
dropped.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.serving.engine import (
    HandoffRecord,
    Request,
    ServingEngine,
)
from midgpt_tpu_torch.serving.faults import (
    AdmissionRejected,
    ClusterUnavailable,
    FaultPlan,
    HandoffFailed,
    PoolOverloaded,
    ReplicaCrash,
    TransientDispatchError,
    WedgedDispatch,
)
from midgpt_tpu_torch.serving.telemetry import EngineTelemetry

__all__ = ["ServingCluster", "serving_devices", "serving_meshes"]


class _WatchdogTrip(Exception):
    """The watchdog's wait on a replica step expired with the step's
    thread still running: the one cold failover. Kept apart from a
    ``TimeoutError`` raised inside ``step()`` (the same class as
    ``concurrent.futures.TimeoutError`` on Python 3.11+), whose thread has
    ended and allows the warm drain."""


def serving_devices(tp_size: int = 1, dp_replicas: int = 1,
                    devices: tp.Optional[tp.Sequence] = None
                    ) -> tp.List[torch.device]:
    """One device per replica of a data-parallel deployment: the first
    ``dp_replicas`` of ``devices`` (default: the CUDA devices). A
    replica's ``tp_size`` tensor ranks run on its device, as the virtual
    ranks of a loopback mesh (:func:`serving_meshes` with
    ``loopback=True``)."""
    if tp_size < 1 or dp_replicas < 1:
        raise ValueError(f"tp_size and dp_replicas must be >= 1, got "
                         f"{tp_size}, {dp_replicas}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < dp_replicas:
        raise ValueError(f"dp_replicas={dp_replicas} needs {dp_replicas} "
                         f"devices, have {len(devices)}")
    return devices[:dp_replicas]


def serving_meshes(tp_size: int = 1, dp_replicas: int = 1,
                   devices: tp.Optional[tp.Sequence] = None, *,
                   loopback: bool = False) -> tp.List:
    """Tensor-only serving meshes of a TP x DP deployment (JAX's
    ``serving_meshes``): ``[None]`` for one replica at ``tp_size == 1``
    (the single-card engine); otherwise one
    :class:`~midgpt_tpu_torch.parallel.mesh.ServingMesh` a replica, whose
    fingerprints differ (replica ``i`` takes device ids ``i tp ..``).

    ``loopback=True`` runs replica ``i``'s ``tp_size`` ranks as virtual
    ranks in this process on ``serving_devices(...)[i]`` (one card's
    path); it is asked for, never taken because devices are missing.
    Without it, ``tp_size > 1`` needs a card a rank, which one process
    does not drive (``NotImplementedError``: ROADMAP A5; a rank a
    process is ``parallel.mesh.group_mesh``), and ``tp_size == 1``
    replicas take a device each."""
    from midgpt_tpu_torch.parallel.mesh import loopback_mesh

    if tp_size < 1 or dp_replicas < 1:
        raise ValueError(f"tp_size and dp_replicas must be >= 1, got "
                         f"{tp_size}, {dp_replicas}")
    if tp_size == 1 and dp_replicas == 1:
        return [None]
    if tp_size > 1 and not loopback:
        raise NotImplementedError(
            f"tensor={tp_size} over several cards in one process is not "
            f"ported (ROADMAP A5): pass loopback=True to hold a replica's "
            f"ranks on one card, or run a rank a process (group_mesh)")
    devs = serving_devices(tp_size, dp_replicas, devices)
    return [loopback_mesh(tp_size, d, first_id=i * tp_size)
            for i, d in enumerate(devs)]


class ServingCluster:
    """N :class:`ServingEngine` replicas, least-loaded admission and
    health-tracked failover (module docstring). Request ids are the
    cluster's own; the engines' ids stay inside. Every other keyword
    argument goes to every engine as it is.

    ``replicas=N`` runs N engines on the engines' ``device`` (one card);
    ``devices`` gives replica i ``devices[i]``, all one device, where the
    model lives; ``meshes`` (:func:`serving_meshes`) gives replica i the
    serving mesh ``meshes[i]`` (None: the single-card engine), all on one
    device. ``prefill_replicas=P,
    decode_replicas=D`` makes the disaggregated pools (``replicas``, if
    given, must be P + D). ``affinity`` and ``affinity_max_imbalance``
    route by resident prefix. ``dispatch_timeout_s`` (None: no watchdog)
    bounds a round's wait for the replicas' steps; ``max_retries``,
    ``backoff_s`` and ``backoff_cap_s`` shape the retries of a transient
    fault (``min(backoff_s * 2**attempt, backoff_cap_s)`` seconds before
    each). ``fault_plan`` gives replica i the hook ``fault_plan.hook(i)``.
    ``flight_dir`` receives a flight-recorder dump of every replica that
    dies (``flight_replica{i}_{reason}.json``)."""

    def __init__(
        self,
        model,
        *,
        replicas: tp.Optional[int] = None,
        devices: tp.Optional[tp.Sequence] = None,
        meshes: tp.Optional[tp.Sequence] = None,
        prefill_replicas: tp.Optional[int] = None,
        decode_replicas: tp.Optional[int] = None,
        affinity: bool = False,
        affinity_max_imbalance: int = 4,
        fault_plan: tp.Optional[FaultPlan] = None,
        dispatch_timeout_s: tp.Optional[float] = None,
        max_retries: int = 3,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        flight_dir: tp.Optional[str] = None,
        **engine_kwargs,
    ):
        roles: tp.Optional[tp.List[str]] = None
        if prefill_replicas is not None or decode_replicas is not None:
            if not (prefill_replicas is not None and prefill_replicas >= 1
                    and decode_replicas is not None and decode_replicas >= 1):
                raise ValueError(
                    f"disaggregated pools need prefill_replicas >= 1 and "
                    f"decode_replicas >= 1, got {prefill_replicas}+"
                    f"{decode_replicas}")
            total = prefill_replicas + decode_replicas
            if replicas is not None and replicas != total:
                raise ValueError(f"replicas={replicas} contradicts "
                                 f"{prefill_replicas}+{decode_replicas}")
            replicas = total
            roles = ["prefill"] * prefill_replicas + ["decode"] * (
                decode_replicas)
        mesh_of: tp.List = []
        if meshes is not None:
            if devices is not None:
                raise ValueError("pass meshes= or devices=, not both")
            mesh_of = list(meshes)
            if not mesh_of:
                raise ValueError("meshes= is empty")
            if replicas is not None and replicas != len(mesh_of):
                raise ValueError(f"replicas={replicas} contradicts "
                                 f"{len(mesh_of)} meshes")
            if any(m is not None and m.tensor.grouped for m in mesh_of):
                raise NotImplementedError(
                    "replicas over a process group are not ported "
                    "(ROADMAP A5)")
            places = {str(m.device) for m in mesh_of if m is not None}
            if "device" in engine_kwargs and any(m is None for m in mesh_of):
                places.add(str(torch.device(engine_kwargs["device"])))
            if len(places) > 1:
                raise NotImplementedError(
                    "replicas over several devices are not ported "
                    "(ROADMAP A5: they wait for a second card)")
            replicas = len(mesh_of)
        if devices is None:
            if replicas is None or replicas < 1:
                raise ValueError("need replicas=N, prefill_replicas=P + "
                                 "decode_replicas=D, or devices=")
            devs: tp.List[tp.Optional[torch.device]] = [None] * replicas
        else:
            devs = [torch.device(d) for d in devices]
            if replicas is not None and replicas != len(devs):
                raise ValueError(f"replicas={replicas} contradicts "
                                 f"{len(devs)} devices")
            if not devs:
                raise ValueError("devices= is empty")
            if "device" in engine_kwargs:
                raise ValueError("pass devices= or device=, not both")
            if len({str(d) for d in devs}) > 1:
                raise NotImplementedError(
                    "replicas over several devices are not ported "
                    "(ROADMAP Q9: they wait for a second card)")
        if max_retries < 0 or backoff_s < 0.0:
            raise ValueError(f"max_retries and backoff_s must be >= 0, got "
                             f"{max_retries}, {backoff_s}")
        # a shared EngineTelemetry would interleave the event streams of
        # replicas stepping on different threads: telemetry=True gives
        # each its own
        if isinstance(engine_kwargs.get("telemetry"), EngineTelemetry) and (
                len(devs) > 1):
            raise ValueError("pass telemetry=True for a cluster of several "
                             "replicas: each needs its own EngineTelemetry")
        self.flight_dir = flight_dir
        self.flight_dumps: tp.List[str] = []
        self.engines: tp.List[ServingEngine] = []
        for i, dev in enumerate(devs):
            kw = dict(engine_kwargs)
            if dev is not None:
                kw["device"] = dev
            if mesh_of:
                kw["mesh"] = mesh_of[i]
            if roles is not None:
                kw["role"] = roles[i]
            if fault_plan is not None:
                kw["fault_hook"] = fault_plan.hook(i)
            self.engines.append(ServingEngine(model, **kw))
        self.disaggregated = roles is not None
        self.prefill_replicas = int(prefill_replicas or 0)
        self.decode_replicas = int(decode_replicas or 0)
        n = len(self.engines)
        self._prefill_pool = (list(range(self.prefill_replicas))
                              if self.disaggregated else list(range(n)))
        self._decode_pool = (list(range(self.prefill_replicas, n))
                             if self.disaggregated else [])
        self.affinity = bool(affinity)
        self.affinity_max_imbalance = int(affinity_max_imbalance)
        if self.affinity_max_imbalance < 0:
            raise ValueError(f"affinity_max_imbalance must be >= 0, got "
                             f"{affinity_max_imbalance}")
        self.dispatch_timeout_s = dispatch_timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        # healthy -> suspect (retrying) -> healthy, or -> dead (terminal: a
        # wedged step may still hold the engine)
        self.health: tp.List[str] = ["healthy"] * n
        self.health_reason: tp.List[tp.Optional[str]] = [None] * n
        self.watchdog_trips = 0
        self.retries = 0
        self.failovers = 0
        self.requeued_requests = 0
        self.handoffs = 0
        self.handoff_pages_moved = 0
        self.handoff_bytes = 0
        self.handoff_failures = 0
        self.prefix_affinity_hits = 0
        self.routed_fallback = 0
        self.first_fault_time: tp.Optional[float] = None
        # cluster id -> (replica, engine id)
        self._route: tp.Dict[int, tp.Tuple[int, int]] = {}
        # cluster id -> (prompt, max_new_tokens, eos_id, seed, submit
        # time, priority, deadline, routing decision): what a cold
        # failover serves again (dropped at harvest)
        self._submitted: tp.Dict[int, tp.Tuple] = {}
        # cluster id -> HandoffRecord exported and not yet imported: host
        # data, so it outlives its source replica
        self._handoff: tp.Dict[int, HandoffRecord] = {}
        self._next_rid = 0
        self.finished: tp.Dict[int, Request] = {}
        self.cancelled: tp.Dict[int, Request] = {}
        self.expired: tp.Dict[int, Request] = {}
        # replicas share the device's stream, where threads overlap
        # nothing on the card and their GIL hand-offs cost about 2x the
        # steps in turn (PERF.md §6, an H100 at 124M): they step in turn
        # on the caller's thread. A watchdog's wait must be one it can
        # abandon, so under one every replica steps on a worker. The pool
        # is over-provisioned: a wedged step holds its worker until the
        # stall ends, and retries still need one
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(
                max_workers=max(4, 2 * n),
                thread_name_prefix="serving-replica")
            if dispatch_timeout_s is not None else None)

    @property
    def replicas(self) -> int:
        return len(self.engines)

    def _alive(self) -> tp.List[int]:
        return [i for i in range(len(self.engines))
                if self.health[i] != "dead"]

    @property
    def has_work(self) -> bool:
        """Requests not yet harvested remain: routed ones (routes outlive
        a replica's death), handoff records between pools, or work on a
        live engine."""
        return bool(self._route) or bool(self._handoff) or any(
            self.engines[i].has_work for i in self._alive())

    def _load(self, e: ServingEngine) -> int:
        """A replica's backlog in requests: queued, parked and running."""
        return len(e.queue) + len(e.parked) + len(e._active_slots())

    def _least_loaded(self, alive: tp.Sequence[int]) -> int:
        return min(alive, key=lambda j: (self._load(self.engines[j]), j))

    def _submit_targets(self) -> tp.List[int]:
        """Where admission and a cold re-serve may go: the live prefill
        pool when disaggregated, any live replica once it is all dead."""
        alive = self._alive()
        if not self.disaggregated:
            return alive
        pool = [i for i in self._prefill_pool if self.health[i] != "dead"]
        return pool or alive

    def _affinity_overlap(self, j: int, toks: tp.Sequence[int]) -> int:
        """Tokens of ``toks`` replica ``j``'s prefix index holds (a
        read-only probe)."""
        idx = self.engines[j].index
        if idx is None or not toks:
            return 0
        return int(idx.match(list(toks))[2])

    def _route_order(self, cands: tp.Sequence[int], prompt: np.ndarray,
                     max_new_tokens: int) -> tp.Tuple[tp.List[int], int]:
        """Candidates in admission order and the best resident overlap (0
        with affinity off or no match). With affinity, the longest
        overlap among replicas within ``affinity_max_imbalance`` of the
        least load (ties: less load, then lower index) goes first, the
        least-loaded order after it. The probe crops the prompt as
        ``ServingEngine.submit`` will and leaves out the last token, as
        admission does."""
        loads = {j: self._load(self.engines[j]) for j in cands}
        order = sorted(cands, key=lambda j: (loads[j], j))
        if not self.affinity:
            return order, 0
        pp = np.asarray(prompt, np.int32).reshape(-1)
        keep = self.engines[order[0]].block - max_new_tokens
        if 0 < keep < pp.size:
            pp = pp[-keep:]
        toks = [int(t) for t in pp[:-1]] if pp.size > 1 else []
        cap = loads[order[0]] + self.affinity_max_imbalance
        eligible = [j for j in cands if loads[j] <= cap]
        best = max(eligible, key=lambda j: (
            self._affinity_overlap(j, toks), -loads[j], -j))
        overlap = self._affinity_overlap(best, toks)
        if overlap > 0:
            order = [best] + [j for j in order if j != best]
        return order, overlap

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               eos_id: tp.Optional[int] = None, seed: int = 0,
               priority: int = 0, deadline_s: tp.Optional[float] = None,
               deadline: tp.Optional[float] = None) -> int:
        """Admit onto the least-loaded live replica (the prefill pool when
        disaggregated; the affinity target first with ``affinity=True``)
        and return the cluster's request id. Raises
        :class:`ClusterUnavailable` when every replica is dead; the
        engine's ``AdmissionRejected`` and ``PoolOverloaded`` pass through
        and use no id. A ``queue_full`` outcome tries the next replica in
        order and raises only at the last."""
        if not self._alive():
            raise ClusterUnavailable("every replica is dead")
        order, overlap = self._route_order(self._submit_targets(), prompt,
                                           max_new_tokens)
        # the absolute deadline is fixed at first admission and rides the
        # submission record, so a cold re-serve keeps the original SLO
        if deadline is None and deadline_s is not None:
            deadline = self.engines[order[0]].clock() + deadline_s
        local = None
        for n, i in enumerate(order):
            try:
                local = self.engines[i].submit(
                    prompt, max_new_tokens, eos_id=eos_id, seed=seed,
                    priority=priority, deadline=deadline)
                break
            except (AdmissionRejected, PoolOverloaded) as exc:
                if exc.reason != "queue_full" or n == len(order) - 1:
                    raise
        # scored at the replica that admitted: spilling over off the
        # affinity target is a fallback
        routed = "least_loaded"
        if self.affinity:
            if overlap > 0 and n == 0:
                routed = "affinity"
                self.prefix_affinity_hits += 1
                self.engines[i]._emit("routed_affinity", rid=local,
                                      overlap=overlap, replica=i)
            else:
                routed = "fallback"
                self.routed_fallback += 1
                self.engines[i]._emit("routed_fallback", rid=local,
                                      replica=i)
        rid = self._next_rid
        self._next_rid += 1
        self._route[rid] = (i, local)
        # the cold failover's record, with the original submit time, so a
        # re-served request's TTFT still shows the outage
        self._submitted[rid] = (
            np.asarray(prompt, np.int32).reshape(-1).copy(),
            max_new_tokens, eos_id, seed, self.engines[i].clock(),
            priority, deadline, routed,
        )
        return rid

    def cancel(self, rid: int) -> bool:
        """Tear the request down wherever it is now (the route follows
        failover; a record between pools is dropped); True when it was
        live. The submission record goes too, so no later cold failover
        serves it again."""
        rec = self._handoff.pop(rid, None)
        if rec is not None:
            # the exported record is the request now: no engine holds it
            rec.req.outcome = "cancelled"
            self.cancelled[rid] = rec.req
            self._submitted.pop(rid, None)
            return True
        route = self._route.get(rid)
        if route is None:
            return False
        i, local = route
        req = self.engines[i].lookup(local)
        if self.health[i] == "dead" or req is None:
            if req is not None and req.outcome != "pending":
                # already ended on the dead replica: harvested as it ended
                dest = {"finished": self.finished,
                        "cancelled": self.cancelled,
                        "expired": self.expired}[req.outcome]
                dest[rid] = req
                del self._route[rid]
                self._submitted.pop(rid, None)
                return req.outcome == "cancelled"
            # an abandoned replica is never touched again: the request is
            # its submission record, and dropping it is the cancellation
            prompt, n, eos_id, seed = self._submitted[rid][:4]
            req = self.engines[i].make_request(prompt, n, eos_id=eos_id,
                                               seed=seed)
            req.rid = local
            req.outcome = "cancelled"
            self.cancelled[rid] = req
            del self._route[rid]
            self._submitted.pop(rid, None)
            return True
        ok = self.engines[i].cancel(local)
        if ok:
            self.cancelled[rid] = self.engines[i].cancelled[local]
            del self._route[rid]
            self._submitted.pop(rid, None)
        return ok

    def lookup(self, rid: int) -> tp.Optional[Request]:
        """The live or ended :class:`Request` of a cluster id (the front
        door's harvest). After a cold failover it is the survivor's fresh
        request, whose tokens grow the same stream again from zero."""
        for d in (self.finished, self.cancelled, self.expired):
            req = d.get(rid)
            if req is not None:
                return req
        rec = self._handoff.get(rid)
        if rec is not None:
            return rec.req  # between pools: live
        route = self._route.get(rid)
        if route is None:
            return None
        i, local = route
        if self.health[i] == "dead":
            return None  # between a death and its failover
        return self.engines[i].lookup(local)

    def _harvest(self) -> None:
        for rid, (i, local) in list(self._route.items()):
            e = self.engines[i]
            for d, dest in ((e.finished, self.finished),
                            (e.cancelled, self.cancelled),
                            (e.expired, self.expired)):
                req = d.get(local)
                if req is not None:
                    dest[rid] = req
                    del self._route[rid]
                    self._submitted.pop(rid, None)
                    break

    # -- failures -------------------------------------------------------------

    def _mark_dead(self, i: int, reason: str) -> None:
        self.health[i] = "dead"
        self.health_reason[i] = reason
        if self.first_fault_time is None:
            self.first_fault_time = time.monotonic()
        if self.flight_dir is not None:
            self._flight_dump(i, reason)

    def _flight_dump(self, i: int, reason: str) -> None:
        """Dump replica ``i``'s flight recorder where every death passes.
        Best effort: after a watchdog trip its step may still append to
        the rings, and a failed dump must not stop the failover it
        records, so it becomes a line on stderr."""
        path = os.path.join(self.flight_dir,
                            f"flight_replica{i}_{reason}.json")
        try:
            rec = self.engines[i].flight_dump(reason, path=path,
                                              extra={"replica": i})
            self.flight_dumps.append(rec["path"])
        except Exception as e:  # noqa: BLE001 (see the docstring)
            print(f"flight-recorder dump for replica {i} ({reason}) "
                  f"failed: {e}", file=sys.stderr)

    def _failover(self, i: int, cold: bool = False) -> None:
        """Move dead replica ``i``'s requests to the survivors; cluster ids
        keep naming the same requests. Warm: the engine drains (running
        slots convert as an eviction does) and the requests go on with
        their progress. Cold (a watchdog trip: the step may still run):
        the engine is never touched again and each request is served
        again from its submission record, with its original submit time.
        Both through ``resubmit``: accepted work skips the queue bound."""
        self._harvest()
        self.failovers += 1
        drained = (None if cold else
                   {r.rid: r for r in self.engines[i].drain_requests()})
        mine = [g for g, (ri, _) in self._route.items() if ri == i]
        n_moved = len(mine) if cold else len(drained)
        self.requeued_requests += n_moved
        if not self._alive():
            if self._route or self._handoff:
                raise ClusterUnavailable(
                    f"replica {i} died ({self.health_reason[i]}) with "
                    f"{n_moved} requests to fail over and no survivors")
            return
        # disaggregated: failed-over work goes through the prefill pool
        # again and hands off again
        targets = self._submit_targets()
        for grid in mine:
            if cold:
                prompt, n, eos_id, seed, t0, prio, deadline, _ = (
                    self._submitted[grid])
                j = self._least_loaded(targets)
                req = self.engines[j].make_request(
                    prompt, n, eos_id=eos_id, seed=seed, priority=prio,
                    deadline=deadline)
                req.submit_time = t0
            else:
                req = drained.pop(self._route[grid][1], None)
                if req is None:
                    continue  # finished, harvested above
                j = self._least_loaded(targets)
            self._route[grid] = (j, self.engines[j].resubmit(req))
        if not cold and drained:
            raise AssertionError(
                f"drained requests {sorted(drained)} had no cluster route")

    # -- the prefill -> decode handoff pump -----------------------------------

    def _requeue_cold(self, grid: int) -> None:
        """Serve one request again from its submission record on the
        least-loaded submit target (a failed export's cold re-serve)."""
        prompt, n, eos_id, seed, t0, prio, deadline, _ = self._submitted[grid]
        targets = self._submit_targets()
        if not targets:
            raise ClusterUnavailable(
                f"no replica alive to serve request {grid} again")
        j = self._least_loaded(targets)
        req = self.engines[j].make_request(prompt, n, eos_id=eos_id,
                                           seed=seed, priority=prio,
                                           deadline=deadline)
        req.submit_time = t0
        self._route[grid] = (j, self.engines[j].resubmit(req))
        self.requeued_requests += 1

    def _pump_handoffs(self) -> None:
        """Move every handoff-ready slot of the prefill pool to the decode
        pool: export (on the source's stream), then import into the
        least-loaded live decode replica (on its stream). Runs after every
        replica's step has settled. A full decode pool keeps the record
        for the next round; a dead one degrades to the live prefill
        replicas (a prefill-role engine decodes an imported slot). A
        failed export releases the source slot and serves the request
        again cold."""
        if not self.disaggregated:
            return
        rev = {route: g for g, route in self._route.items()}
        for i in self._prefill_pool:
            if self.health[i] == "dead":
                continue
            eng = self.engines[i]
            for s in eng.handoff_ready_slots():
                req = eng.slot_req[s]
                grid = rev.get((i, req.rid))
                if grid is None:
                    continue  # not the cluster's (the engine used directly)
                t0 = eng.clock()
                try:
                    with eng.on_stream():
                        rec = eng.export_request(s)
                except HandoffFailed:
                    self.handoff_failures += 1
                    # nothing left the slot: release it (not a cancel)
                    eng._live.pop(req.rid, None)
                    eng._release_slot(s)
                    del self._route[grid]
                    self._requeue_cold(grid)
                    continue
                if eng.telemetry is not None:
                    eng.telemetry.record_dispatch(
                        "handoff", step=eng.fault_step, t=t0,
                        dur=eng.clock() - t0, rids=(req.rid,), tokens=0,
                        pages=rec.n_pages, bytes=rec.nbytes)
                del self._route[grid]
                self._handoff[grid] = rec
        for grid in list(self._handoff):
            rec = self._handoff[grid]
            targets = [j for j in self._decode_pool
                       if self.health[j] != "dead"] or [
                j for j in self._prefill_pool if self.health[j] != "dead"]
            for j in sorted(targets,
                            key=lambda j: (self._load(self.engines[j]), j)):
                with self.engines[j].on_stream():
                    local = self.engines[j].import_request(rec)
                if local is not None:
                    self._route[grid] = (j, local)
                    del self._handoff[grid]
                    self.handoffs += 1
                    self.handoff_pages_moved += rec.n_pages
                    self.handoff_bytes += rec.nbytes
                    break

    @staticmethod
    def _classify(exc: BaseException) -> tp.Tuple[str, bool]:
        """(reason, cold) for a terminal fault: only a watchdog trip is
        cold; anything else was raised by a step that ended."""
        if isinstance(exc, _WatchdogTrip):
            return "wedged", True
        if isinstance(exc, WedgedDispatch):
            return "wedged", False
        return "crashed", False

    def _mark_terminal(self, i: int, exc: BaseException) -> bool:
        """Count and mark a terminal fault dead; True when its failover
        runs cold. Kept apart from the failover, so a round marks all its
        dead before it moves any request."""
        reason, cold = self._classify(exc)
        if reason == "wedged":
            self.watchdog_trips += 1
        self._mark_dead(i, reason)
        return cold

    def _terminal_failure(self, i: int, exc: BaseException) -> None:
        self._failover(i, cold=self._mark_terminal(i, exc))

    @staticmethod
    def _settle(f, timeout: tp.Optional[float]) -> bool:
        """Wait for one replica step's future. Raises :class:`_WatchdogTrip`
        only when the wait expires with the step still running."""
        try:
            return bool(f.result(timeout=timeout))
        except concurrent.futures.TimeoutError:
            if not f.done():
                raise _WatchdogTrip() from None
            exc = f.exception()
            if exc is None:
                return bool(f.result())  # done right at the deadline
            raise exc

    def _step_engine(self, i: int) -> bool:
        """Replica ``i``'s step on its own stream (the worker's current
        stream is the default one)."""
        eng = self.engines[i]
        with eng.on_stream():
            return bool(eng.step())

    def _step_one(self, i: int, timeout: tp.Optional[float]) -> bool:
        if self._pool is None:
            return self._step_engine(i)
        return self._settle(self._pool.submit(self._step_engine, i), timeout)

    def _recover(self, i: int) -> None:
        """Retry replica ``i`` after a transient fault: capped exponential
        backoff, suspect meanwhile, healthy on a success, dead and failed
        over when the retries run out (or a retry meets a harder fault).
        The sleeps run on the scheduler's thread, so a scripted sequence
        of transients replays exactly; ``backoff_cap_s`` bounds them."""
        self.health[i] = "suspect"
        self.health_reason[i] = "transient"
        for attempt in range(self.max_retries):
            time.sleep(min(self.backoff_s * (2 ** attempt),
                           self.backoff_cap_s))
            self.retries += 1
            try:
                self._step_one(i, self.dispatch_timeout_s)
            except TransientDispatchError:
                continue
            except self._STEP_FAULTS as exc:
                self._terminal_failure(i, exc)
                return
            self.health[i] = "healthy"
            self.health_reason[i] = None
            return
        self._mark_dead(i, "transient_exhausted")
        self._failover(i)

    # every fault a replica step may raise; anything else is a bug and
    # propagates (concurrent.futures.TimeoutError is listed for Pythons
    # where it is not the builtin)
    _STEP_FAULTS = (
        TransientDispatchError,
        WedgedDispatch,
        ReplicaCrash,
        TimeoutError,
        concurrent.futures.TimeoutError,
        _WatchdogTrip,
    )

    def step(self) -> bool:
        """One scheduler window on every live replica: in turn on this
        thread, or on their workers at once under a watchdog. Every step
        settles (ends, raises or trips the watchdog, one deadline for the
        round) before any failure is handled: all terminal faults are
        marked dead first, then transients retry,
        then the failovers run, then the handoffs are pumped and the
        finished requests harvested. Returns True while there was work;
        raises :class:`ClusterUnavailable` when every replica is dead
        with requests pending."""
        alive = self._alive()
        if not alive:
            if self._route or self._handoff:
                raise ClusterUnavailable(
                    "every replica is dead with requests pending")
            return False
        progressed = False
        faults: tp.List[tp.Tuple[int, BaseException]] = []
        if self._pool is None:
            for i in alive:
                try:
                    progressed = self._step_engine(i) or progressed
                except self._STEP_FAULTS as exc:
                    faults.append((i, exc))
        else:
            futs = [(i, self._pool.submit(self._step_engine, i))
                    for i in alive]
            deadline = (None if self.dispatch_timeout_s is None
                        else time.monotonic() + self.dispatch_timeout_s)
            for i, f in futs:
                try:
                    r = self._settle(f, None if deadline is None else
                                     max(0.0, deadline - time.monotonic()))
                    progressed = r or progressed
                except self._STEP_FAULTS as exc:
                    faults.append((i, exc))
        # a fault is progress: its requests moved or retried
        progressed = progressed or bool(faults)
        # two replicas failing in one round must not fail over onto each
        # other
        terminal = [(i, self._mark_terminal(i, exc)) for i, exc in faults
                    if not isinstance(exc, TransientDispatchError)]
        for i, exc in faults:
            if isinstance(exc, TransientDispatchError):
                self._recover(i)
        for i, cold in terminal:
            self._failover(i, cold=cold)
        self._pump_handoffs()
        self._harvest()
        return progressed

    def run(self, max_windows: int = 100_000) -> tp.Dict[int, Request]:
        """Step until every request is harvested; returns the finished
        requests by cluster id."""
        for _ in range(max_windows):
            if not self.has_work:
                break
            self.step()
        else:
            raise RuntimeError(
                f"cluster did not drain in {max_windows} windows")
        self._harvest()
        return self.finished

    def _cluster_counters(self) -> tp.Dict[str, tp.Any]:
        return {
            "dp_replicas": len(self.engines),
            "prefill_replicas": self.prefill_replicas,
            "decode_replicas": self.decode_replicas,
            "watchdog_trips": self.watchdog_trips,
            "retries": self.retries,
            "failovers": self.failovers,
            "requeued_requests": self.requeued_requests,
            "handoffs": self.handoffs,
            "handoff_pages_moved": self.handoff_pages_moved,
            "handoff_bytes": self.handoff_bytes,
            "handoff_failures": self.handoff_failures,
            "prefix_affinity_hits": self.prefix_affinity_hits,
            "routed_fallback": self.routed_fallback,
            "dead_replicas": self.health.count("dead"),
            "replica_health": list(self.health),
            "replica_health_reason": list(self.health_reason),
        }

    def stats(self) -> tp.Dict[str, tp.Any]:
        """The engines' counters summed in ``ServingEngine.stats``' layout
        (the rates averaged, ``tp`` replica 0's, labeled families merged),
        the cluster's counters and the ``per_replica`` breakdown: exactly
        the keys of ``CLUSTER_STATS_KEYS``."""
        per = [e.stats() for e in self.engines]
        agg: tp.Dict[str, tp.Any] = {}
        for k in per[0]:
            if k in ("slot_occupancy", "prefix_hit_rate",
                     "tokens_per_dispatch", "spec_acceptance_rate"):
                agg[k] = round(sum(s[k] for s in per) / len(per), 4)
            elif k == "tp":
                agg[k] = per[0][k]
            elif isinstance(per[0][k], dict):
                merged: tp.Dict[str, int] = {}
                for s in per:
                    for kk, vv in s[k].items():
                        merged[kk] = merged.get(kk, 0) + vv
                agg[k] = merged
            else:
                agg[k] = sum(s[k] for s in per)
        agg.update(self._cluster_counters())
        agg["per_replica"] = per
        return agg

    @property
    def telemetries(self) -> tp.List[tp.Optional[EngineTelemetry]]:
        """Each replica's telemetry (None with tracing off)."""
        return [e.telemetry for e in self.engines]

    def metrics_snapshot(self) -> tp.Dict[str, tp.Any]:
        """The cluster's counters and health beside every replica's
        ``metrics_snapshot()`` (``prometheus_text`` expands it per
        replica)."""
        return {
            "cluster": dict(self._cluster_counters(),
                            flight_dumps=list(self.flight_dumps)),
            "replicas": [e.metrics_snapshot() for e in self.engines],
        }
