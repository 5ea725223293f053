"""Kernel launch counts: each wrapper's ``launches`` attribute.

A wrapper calls :func:`count` where it launches its kernel. Outside a
recording that adds one to the wrapper's ``launches``. Inside
:func:`recording` (per thread) the launch goes into the recording
instead: the serving engine records the launches of a program's warm-up
call and of its CUDA graph capture there, and every replay of the graph
adds the capture's record with :func:`add`. So ``launches`` counts the
kernels that ran on the main path, one replay's worth per replay, and
another thread's counts never mix with a capture's. A train step's
capture records with ``all_threads=True``: its backward launches its
kernels from autograd's device thread, not the capturing one.
"""

from __future__ import annotations

import contextlib
import threading
import typing as tp

_LOCAL = threading.local()
# the recording of every thread without one of its own (all_threads)
_GLOBAL: tp.List[tp.Optional[tp.Dict[tp.Callable, int]]] = [None]
_LOCK = threading.Lock()


# every wrapper that has counted, by name (snapshot)
_SEEN: tp.Dict[str, tp.Callable] = {}


def name(wrapper: tp.Callable) -> str:
    """``<module>.<function>``, e.g. ``fused_attn.fused_attention_fwd``."""
    return f"{wrapper.__module__.rsplit('.', 1)[-1]}.{wrapper.__name__}"


def snapshot() -> tp.Dict[str, int]:
    """Every wrapper that has counted, by :func:`name`: its ``launches``."""
    with _LOCK:
        return {n: w.launches for n, w in _SEEN.items()}


def names(rec: tp.Mapping[tp.Callable, int]) -> tp.Dict[str, int]:
    """A recording keyed by :func:`name`."""
    return {name(w): n for w, n in rec.items()}


def count(wrapper: tp.Callable, n: int = 1) -> None:
    """``n`` launches of ``wrapper``'s kernel."""
    rec = getattr(_LOCAL, "record", None)
    with _LOCK:
        _SEEN.setdefault(name(wrapper), wrapper)
        if rec is None:
            rec = _GLOBAL[0]
        if rec is None:
            wrapper.launches += n
        else:
            rec[wrapper] = rec.get(wrapper, 0) + n


@contextlib.contextmanager
def recording(all_threads: bool = False
              ) -> tp.Iterator[tp.Dict[tp.Callable, int]]:
    """Launches on this thread (with ``all_threads``, on every thread
    that has no recording of its own) go into the yielded ``{wrapper:
    n}``, not onto the wrappers' counts."""
    rec: tp.Dict[tp.Callable, int] = {}
    if all_threads:
        prev, _GLOBAL[0] = _GLOBAL[0], rec
    else:
        prev = getattr(_LOCAL, "record", None)
        _LOCAL.record = rec
    try:
        yield rec
    finally:
        if all_threads:
            _GLOBAL[0] = prev
        else:
            _LOCAL.record = prev


def add(rec: tp.Dict[tp.Callable, int]) -> None:
    """Count a recording's launches again (a replay of what it recorded)."""
    for wrapper, n in rec.items():
        count(wrapper, n)
