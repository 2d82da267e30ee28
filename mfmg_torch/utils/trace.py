"""The port's tracing: named spans on the profiler's clock and their counts.

Tracing is off by default; ``enable()`` and ``disable()`` switch it.  Off,
``span(name)`` reads one global and returns one shared null context: it
allocates nothing, formats no string and calls no torch API.  On, each span
records ``Span(name, start_ns, end_ns, parent, request)`` in a bounded
buffer (``MAX_SPANS``; spans beyond it are counted in ``dropped()`` and not
kept) and counts one for its name in ``counts()``; ``take()`` returns the
finished spans and clears them and the counts.

    from mfmg_torch.utils import trace
    trace.enable()
    x, info = hier.solve_cg(b, tol=1e-5)
    trace.disable()
    spans = trace.take()     # "solve", "pcg.iteration", "vcycle", ...

The clock is ``time.time_ns()``, CLOCK_REALTIME on Linux, on which torch's
profiler stamps its events (``c10::getTime()``; ``_KinetoEvent.start_ns()``
is absolute), so a span and a profiler event compare without conversion.

``request(name)`` opens a root span that takes a new request id, which the
spans opened inside it inherit (0 outside any request): an entry point such
as ``Hierarchy.solve_cg`` opens one per call.  While a torch profiler
records, every span also opens a ``torch.profiler.record_function`` range of
its name, so that the profiler's trace shows the program's spans beside the
kernels (unless ``enable(profiler_ranges=False)``).  Spans nest per thread
of the program; the port opens them from one thread.
"""

from __future__ import annotations

import time
from array import array
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_SPANS", "Span", "counts", "disable", "dropped", "enable",
           "enabled", "now", "request", "span", "take"]

MAX_SPANS = 1 << 20

now = time.time_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int       # index of the enclosing span in the same take(), or -1
    request: int      # id of the request the span belongs to, 0 outside any


_on = False
_ranges = True            # spans open record_function ranges under a profiler
# the kept spans in start order, in flat storage that holds no object the
# garbage collector tracks (a list per span set off its collections)
_names = []               # name of each span
_fields = array("q")      # start, end, parent index, request id of each
_open = []                # indices of the open spans (-1: not kept)
_open_requests = []       # their request ids
_counts = {}
_dropped = 0
_requests = 0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _push(name, new_request):
    """Count a span of ``name``, open it under the innermost open span, keep
    it where the buffer has room, and return its index (-1: not kept)."""
    global _dropped, _requests
    _counts[name] = _counts.get(name, 0) + 1
    if new_request:
        _requests += 1
        req = _requests
    else:
        req = _open_requests[-1] if _open_requests else 0
    index = len(_names)
    if index < MAX_SPANS:
        _names.append(name)
        _fields.extend((0, 0, _open[-1] if _open else -1, req))
    else:
        index = -1
        _dropped += 1
    _open.append(index)
    _open_requests.append(req)
    return index


class _Open:
    __slots__ = ("_name", "_new_request", "_index", "_rf")

    def __init__(self, name, new_request):
        self._name, self._new_request = name, new_request
        self._rf = None

    def __enter__(self):
        index = self._index = _push(self._name, self._new_request)
        if _ranges and _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        if index >= 0:
            _fields[4 * index] = now()
        return None

    def __exit__(self, *exc):
        if self._index >= 0:
            _fields[4 * self._index + 1] = now()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _open.pop()
        _open_requests.pop()
        return False


def span(name: str):
    """A context manager timing ``name`` while tracing is on; off, the one
    shared null context."""
    if not _on:
        return _NULL
    return _Open(name, False)


def request(name: str):
    """``span(name)`` that takes a new request id for itself and the spans
    opened inside it: the root span of an entry point."""
    if not _on:
        return _NULL
    return _Open(name, True)


def enable(profiler_ranges: bool = True) -> None:
    """Turn tracing on; with ``profiler_ranges`` False no span opens a
    ``record_function`` range (each costs the host some microseconds under a
    profiler), as where only the device's activity is profiled."""
    global _on, _ranges
    _on, _ranges = True, bool(profiler_ranges)


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def counts() -> dict:
    """Spans opened per name since the last ``take()``, kept or dropped."""
    return dict(_counts)


def dropped() -> int:
    """Spans not kept since the last ``take()``: the buffer was full."""
    return _dropped


def take() -> list:
    """The finished spans in start order, with the counts, cleared; parents
    are indices into the returned list.  Raises while a span is open."""
    global _dropped
    if _open:
        raise RuntimeError(f"take() inside an open span ({len(_open)} open)")
    out = [Span(name, *_fields[4 * i:4 * i + 4]) for i, name in enumerate(_names)]
    _names.clear()
    del _fields[:]
    _counts.clear()
    _dropped = 0
    return out
