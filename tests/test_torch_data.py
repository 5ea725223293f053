"""The port's data feed against the JAX package's, on the CPU.

- the native gather (``midgpt_tpu_torch.native``, built with g++ into
  ``build/``) equals its NumPy version and the JAX package's
  ``gather_windows`` bit for bit, at one and at several threads, and its
  bounds check raises (nothing written);
- ``PrefetchLoader`` batches equal the synchronous loader's and the JAX
  package's loader's; its ``state_dict`` counts consumed batches only;
  ``load_state_dict`` drains the queue and resumes at the restored step;
  an exception in the worker reaches ``next()``; ``device_transform`` on
  the CPU gives int64 tensors.
"""

import time

import numpy as np
import pytest
import torch

from midgpt_tpu.data import Loader as JaxLoader
from midgpt_tpu.data import load_shard as jax_load_shard
from midgpt_tpu.native import gather_windows as jax_gather
from midgpt_tpu_torch.data import (
    Loader,
    PrefetchLoader,
    device_transform,
    gather_windows_reference,
    load_shard,
    write_tokens,
)
from midgpt_tpu_torch.native import gather_windows, library_path

torch.set_num_threads(2)


def _tokens(n=100_000, seed=0):
    return np.random.default_rng(seed).integers(0, 50304, n).astype(np.uint16)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_native_gather_matches_numpy_and_jax(n_threads):
    toks = _tokens()
    rng = np.random.default_rng(1)
    # the first and the last window the stream holds among them
    offsets = np.concatenate([[0, len(toks) - 65],
                              rng.integers(0, len(toks) - 65, 61)])
    x, y = gather_windows(toks, offsets, 64, n_threads=n_threads)
    assert x.dtype == y.dtype == np.int32 and x.shape == (63, 64)
    for ref in (gather_windows_reference(toks, offsets, 64),
                jax_gather(toks, offsets, 64)):
        np.testing.assert_array_equal(x, ref[0])
        np.testing.assert_array_equal(y, ref[1])
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    assert library_path().endswith(".so") and "build" in library_path()


@pytest.mark.parametrize("bad", [-1, 100_000 - 64])
def test_native_gather_bounds_check_raises(bad):
    toks = _tokens()
    for gather in (gather_windows, gather_windows_reference):
        with pytest.raises(IndexError, match="out of range"):
            gather(toks, np.array([0, bad]), 64)
    with pytest.raises(TypeError, match="uint16"):
        gather_windows(toks.astype(np.int32), np.array([0]), 64)


def _loaders(tmp_path, shape=(2, 3)):
    path = str(tmp_path / "train.bin")
    write_tokens(path, _tokens(30_000))
    return (Loader(load_shard(path), 64, shape, seed=1234),
            JaxLoader(jax_load_shard(path), 64, shape, seed=1234))


def test_prefetch_batches_equal_the_loader_and_jax(tmp_path):
    ours, ref = _loaders(tmp_path)
    sync = Loader(ours.tokens, 64, (2, 3), seed=1234)
    pre = PrefetchLoader(ours, *device_transform("cpu"), depth=3).start()
    try:
        for _ in range(5):
            x, y = pre.next()
            assert x.dtype == y.dtype == torch.int64
            sx, sy = sync.next()
            jx, jy = ref.next()
            for got, a, b in ((x, sx, jx), (y, sy, jy)):
                np.testing.assert_array_equal(got.numpy(), a)
                np.testing.assert_array_equal(got.numpy(), b)
    finally:
        pre.stop()
    # the wrapped loader is never advanced: the worker draws with peek
    assert ours.step == 0


def test_prefetch_state_counts_consumed_batches_only(tmp_path):
    ours, _ = _loaders(tmp_path)
    pre = PrefetchLoader(ours, depth=4).start()
    try:
        first = [pre.next() for _ in range(2)]
        # let the worker fill its queue ahead of the consumer
        deadline = time.monotonic() + 60
        while pre._queue.qsize() < 4 and time.monotonic() < deadline:
            pre._thread.join(timeout=0.01)
        assert pre._queue.qsize() == 4
        assert pre.state_dict() == {"step": 2, "seed": 1234}
        # a restore drains the queue and replays from the restored step
        pre.load_state_dict({"step": 1, "seed": 1234})
        assert pre._thread is None and pre._queue.qsize() == 0
        again = pre.next()
        np.testing.assert_array_equal(again[0], first[1][0])
        assert pre.state_dict()["step"] == 2
    finally:
        pre.stop()
    with pytest.raises(ValueError, match="seed"):
        pre.load_state_dict({"step": 0, "seed": 1})


def test_prefetch_worker_error_reaches_next(tmp_path):
    ours, _ = _loaders(tmp_path)
    calls = []

    def transform(x, y):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("transform failed on the third batch")
        return x, y

    pre = PrefetchLoader(ours, transform)
    pre.next()
    pre.next()
    with pytest.raises(RuntimeError, match="third batch"):
        pre.next()
    assert pre._thread is None  # the failed generation was stopped
