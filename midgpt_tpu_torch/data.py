"""Token-stream data (counterpart of ``midgpt_tpu.data``).

A uint16 token file, of which each process reads its contiguous
``1 / process_count`` shard; every batch is a pure function of (seed,
step, stream, process index) through a counter-based Philox generator,
so the loader's checkpointed state is its step number and a resume
replays the exact batch sequence. The generator, the shard and the draw
are the JAX package's, so the batches are bit-identical to its loader's
for every (process index, process count).
Windows are gathered by the native multi-threaded gather
(``midgpt_tpu_torch.native``); targets are the inputs shifted by one.

``PrefetchLoader`` draws the next batches on a background thread while
the current step runs, one batch an item or, in window mode, ``[k, G,
B, T]`` stacks of k consecutive batches for a K-step train dispatch (the
JAX package's two modes). On the card its transform
(:func:`device_transform`) pins each item and copies it to the card on a
side stream; the consumer's stream waits on the copy.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.native import gather_windows


def load_shard(path: str, process_index: int = 0,
               process_count: int = 1) -> np.ndarray:
    """Process ``process_index``'s contiguous ``1 / process_count`` slice
    of the uint16 token file at ``path``, in memory (the JAX package's
    equal shards: the last ``n % process_count`` tokens go unread)."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process {process_index} of {process_count}")
    data = np.memmap(path, dtype=np.uint16, mode="r")
    per = len(data) // process_count
    return np.array(data[process_index * per:(process_index + 1) * per])


def _rng(seed: int, step: int, stream: int,
         process_index: int = 0) -> np.random.Generator:
    """Counter-based generator: unique, reproducible per (seed, step,
    stream, process index), the JAX loader's counter words."""
    return np.random.Generator(
        np.random.Philox(key=seed, counter=[0, stream, step, process_index])
    )


def gather_windows_reference(tokens: np.ndarray, offsets: np.ndarray,
                             block_size: int
                             ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """The native gather's plain NumPy version (for the tests): (x, y)
    int32 ``[n, block_size]`` windows at ``offsets``; y is x shifted by
    one."""
    offsets = np.asarray(offsets, dtype=np.int64)
    if np.any(offsets < 0) or np.any(offsets + block_size + 1 > len(tokens)):
        raise IndexError("gather window out of range")
    idx = offsets[:, None] + np.arange(block_size + 1)[None, :]
    windows = tokens[idx].astype(np.int32)
    return windows[:, :-1], windows[:, 1:]


def sample_batch(tokens: np.ndarray, block_size: int,
                 batch_shape: tp.Tuple[int, ...], seed: int, step: int,
                 stream: int = 0, process_index: int = 0
                 ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Random ``block_size`` windows of ``tokens``, with replacement;
    (x, y) int32 shaped ``batch_shape + (block_size,)``."""
    n_seqs = int(np.prod(batch_shape))
    rng = _rng(seed, step, stream, process_index)
    offsets = rng.integers(0, len(tokens) - block_size - 1, size=(n_seqs,))
    x, y = gather_windows(tokens, offsets, block_size)
    return (x.reshape(*batch_shape, block_size),
            y.reshape(*batch_shape, block_size))


@dataclasses.dataclass
class Loader:
    """The loader state is the current step; ``state_dict`` /
    ``load_state_dict`` round-trip it through checkpoints."""

    tokens: np.ndarray  # 1-D uint16
    block_size: int
    batch_shape: tp.Tuple[int, ...]  # e.g. (g_accum, local_batch)
    seed: int
    step: int = 0
    stream: int = 0
    process_index: int = 0  # the last Philox counter word

    def next(self) -> tp.Tuple[np.ndarray, np.ndarray]:
        out = self.peek(self.step)
        self.step += 1
        return out

    def peek(self, step: int) -> tp.Tuple[np.ndarray, np.ndarray]:
        return sample_batch(self.tokens, self.block_size, self.batch_shape,
                            self.seed, step, self.stream, self.process_index)

    def state_dict(self) -> tp.Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: tp.Mapping[str, int]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(
                f"loader seed changed: checkpoint {state['seed']} vs config "
                f"{self.seed}")
        self.step = int(state["step"])


class _PrefetchError:
    """An exception raised on the prefetch thread, carried to the
    consumer (a worker that died silently would hang ``next()``)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _PlanExhausted:
    """The item a worker queues when a finite ``window_plan`` runs out, so
    a ``next()`` past the plan raises instead of waiting forever."""


class PrefetchLoader:
    """Draws a :class:`Loader`'s batches on a background thread, ``depth``
    items ahead of the consumer, each passed through ``transform`` there;
    the consumer's ``next()`` passes what it takes through ``finish`` (on
    the card: the wait on the item's copy, :func:`device_transform`).

    Window mode (``window > 1`` or a ``window_plan``): each item stacks w
    consecutive batches on a new leading axis, ``[w, *batch_shape, T]``,
    w = ``window``, or the plan's next entry; a finite plan ends with a
    sentinel, and a ``next()`` past it raises.

    The worker draws through the pure ``loader.peek`` with a counter of
    its own and never touches the loader, so a worker left behind by
    ``stop`` cannot disturb a later one. ``state_dict`` counts the batches
    of the items the consumer took, not those drawn: a resume, mid-window
    too, replays every batch the queue held. ``load_state_dict`` stops the
    worker, empties the queue and restarts a plan from its first entry.
    An exception in the worker is raised by the ``next()`` that reaches
    it."""

    def __init__(self, loader: Loader,
                 transform: tp.Optional[tp.Callable] = None,
                 finish: tp.Optional[tp.Callable] = None, depth: int = 2,
                 window: int = 1,
                 window_plan: tp.Optional[tp.Sequence[int]] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.loader = loader
        self._transform = transform if transform is not None else (
            lambda *b: b)
        self._finish = finish if finish is not None else (lambda b: b)
        self._depth = depth
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: tp.Optional[threading.Thread] = None
        self._window = window
        self._plan = tuple(window_plan) if window_plan is not None else None
        self._windowed = window > 1 or self._plan is not None
        self._start_step = loader.step
        # batches of the items taken, and the items (a plan's cursor)
        self._consumed = 0
        self._consumed_items = 0

    def _item_sizes(self, from_item: int) -> tp.Iterator[int]:
        if self._plan is not None:
            yield from self._plan[from_item:]
            return
        while True:
            yield self._window

    def _put(self, stop: threading.Event, q: "queue.Queue", item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self, stop: threading.Event, q: "queue.Queue",
                begin_step: int, from_item: int) -> None:
        produced = 0
        for w in self._item_sizes(from_item):
            if stop.is_set():
                return
            try:
                if self._windowed:
                    draws = [self.loader.peek(begin_step + produced + i)
                             for i in range(w)]
                    batch = self._transform(
                        *(np.stack(col) for col in zip(*draws)))
                else:
                    batch = self._transform(
                        *self.loader.peek(begin_step + produced))
                produced += w
                item = (w, batch)
            except BaseException as exc:  # carried to the consumer
                item = (w, _PrefetchError(exc))
            self._put(stop, q, item)
            if isinstance(item[1], _PrefetchError):
                return
        self._put(stop, q, (0, _PlanExhausted()))

    def start(self) -> "PrefetchLoader":
        if self._thread is None:
            # each worker generation has its own stop event and queue
            self._thread = threading.Thread(
                target=self._worker,
                args=(self._stop, self._queue,
                      self._start_step + self._consumed,
                      self._consumed_items),
                daemon=True)
            self._thread.start()
        return self

    def next(self):
        if self._thread is None:
            self.start()
        w, item = self._queue.get()
        if isinstance(item, _PrefetchError):
            self.stop()
            raise item.exc
        if isinstance(item, _PlanExhausted):
            self.stop()
            raise RuntimeError(
                f"PrefetchLoader window_plan exhausted after "
                f"{self._consumed_items} windows ({self._consumed} batches): "
                "next() was called more times than the plan has items")
        self._consumed += w
        self._consumed_items += 1
        return self._finish(item)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            while True:  # unblock a worker waiting on a full queue
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            # a worker stuck in a transform past the timeout holds this
            # generation's (set) stop event and queue, and only ever
            # calls the pure peek: it can feed no later generation
            self._thread.join(timeout=5)
            self._thread = None
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._depth)

    def state_dict(self) -> tp.Dict[str, int]:
        return {"step": self._start_step + self._consumed,
                "seed": self.loader.seed}

    def load_state_dict(self, state: tp.Mapping[str, int]) -> None:
        self.stop()
        self.loader.load_state_dict(state)
        self._start_step = self.loader.step
        self._consumed = 0
        self._consumed_items = 0


class _Staged(tp.NamedTuple):
    """A batch on its way to the card: the device tensors, written on the
    copy stream, and the event recorded after the copy."""

    tensors: tp.Tuple[torch.Tensor, ...]
    event: tp.Any


def device_transform(device: tp.Union[str, torch.device]
                     ) -> tp.Tuple[tp.Callable, tp.Callable]:
    """``(transform, finish)`` for a :class:`PrefetchLoader` feeding
    ``device``: int64 tensors of the batch's arrays, as the training step
    takes them. On the card the transform runs on the prefetch thread:
    it pins each array and copies it with ``non_blocking=True`` on a side
    stream, widens it to int64 there and records an event; ``finish``,
    on the consumer's thread, makes the consumer's stream wait on that
    event and ``record_stream`` s each tensor onto it, so the allocator
    never hands their memory to another tensor while the consumer's work
    may still read it. A window item (``[k, G, B, T]``) goes in one copy
    an array. The consumer calls ``finish`` before it captures or replays
    a train program, never inside a capture: a capture cannot wait on an
    event recorded outside it. On the CPU both are plain conversions."""
    device = torch.device(device)
    if device.type != "cuda":
        return (lambda *arrays: tuple(torch.from_numpy(a).long()
                                      for a in arrays),
                lambda batch: batch)
    copy_stream = torch.cuda.Stream(device)

    def transform(*arrays: np.ndarray) -> _Staged:
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            tensors = tuple(
                torch.from_numpy(a).pin_memory().to(
                    device, non_blocking=True).long()
                for a in arrays)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return _Staged(tensors, event)

    def finish(staged: _Staged) -> tp.Tuple[torch.Tensor, ...]:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(consumer)
        return staged.tensors

    return transform, finish


def write_tokens(path: str, tokens: np.ndarray) -> None:
    """Write a uint16 token stream the way the prep scripts do."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.asarray(tokens, dtype=np.uint16).tofile(path)
