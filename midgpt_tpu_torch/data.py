"""Token-stream data (counterpart of ``midgpt_tpu.data``).

A uint16 token file, read whole; every batch is a pure function of
(seed, step, stream) through a counter-based Philox generator, so the
loader's checkpointed state is its step number and a resume replays the
exact batch sequence. The generator and the draw are the JAX package's,
so the batches are bit-identical to its loader's on one process.
Windows are gathered with NumPy indexing (the JAX package's native
multi-threaded gather and its prefetch thread are not ported); targets
are the inputs shifted by one.
"""

from __future__ import annotations

import dataclasses
import os
import typing as tp

import numpy as np


def load_shard(path: str) -> np.ndarray:
    """The whole uint16 token file at ``path``, in memory."""
    return np.fromfile(path, dtype=np.uint16)


def _rng(seed: int, step: int, stream: int) -> np.random.Generator:
    """Counter-based generator: unique, reproducible per (seed, step,
    stream). The last counter word is the JAX loader's process index,
    always 0 on one card."""
    return np.random.Generator(
        np.random.Philox(key=seed, counter=[0, stream, step, 0])
    )


def gather_windows(tokens: np.ndarray, offsets: np.ndarray,
                   block_size: int) -> tp.Tuple[np.ndarray, np.ndarray]:
    """(x, y) int32 ``[n, block_size]`` windows at ``offsets``; y is x
    shifted by one."""
    offsets = np.asarray(offsets, dtype=np.int64)
    if np.any(offsets < 0) or np.any(offsets + block_size + 1 > len(tokens)):
        raise IndexError("gather window out of range")
    idx = offsets[:, None] + np.arange(block_size + 1)[None, :]
    windows = tokens[idx].astype(np.int32)
    return windows[:, :-1], windows[:, 1:]


def sample_batch(tokens: np.ndarray, block_size: int,
                 batch_shape: tp.Tuple[int, ...], seed: int, step: int,
                 stream: int = 0) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Random ``block_size`` windows of ``tokens``, with replacement;
    (x, y) int32 shaped ``batch_shape + (block_size,)``."""
    n_seqs = int(np.prod(batch_shape))
    rng = _rng(seed, step, stream)
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

    def next(self) -> tp.Tuple[np.ndarray, np.ndarray]:
        out = self.peek(self.step)
        self.step += 1
        return out

    def peek(self, step: int) -> tp.Tuple[np.ndarray, np.ndarray]:
        return sample_batch(self.tokens, self.block_size, self.batch_shape,
                            self.seed, step, self.stream)

    def state_dict(self) -> tp.Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: tp.Mapping[str, int]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(
                f"loader seed changed: checkpoint {state['seed']} vs config "
                f"{self.seed}")
        self.step = int(state["step"])


def write_tokens(path: str, tokens: np.ndarray) -> None:
    """Write a uint16 token stream the way the prep scripts do."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.asarray(tokens, dtype=np.uint16).tofile(path)
