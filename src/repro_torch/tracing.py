"""Spans and counters inside the port, kept in memory.

A **span** is a named interval of host time on one thread: its start and
end in ``time.perf_counter_ns()``, the index of the span that was open
around it on that thread (its parent, ``-1`` for none), the thread, a
call id that every span of one outermost call shares (an engine call's
spans share ``engine.infer_padded``'s) and fixed attributes.  Spans are
recorded only while a ``torch.profiler`` records (its recorded steps, not
its warm-up: torch's own fast flag
``torch.autograd.profiler._is_profiler_enabled``) or while :func:`enable`
is on.  Off, a span site reads that flag and ours and allocates nothing.

>>> @traced("engine.infer", backend="mxu_fused")   # a whole function
... def infer(self, literals): ...
>>> sp = begin("td.race")                         # part of a function
>>> res = race(pdl, delays)
>>> end(sp)

A **recording session** starts when a profiler starts recording or
:func:`enable` is called; :func:`spans` returns the spans of the last
one, so runs in one process do not mix.  The buffer holds ``CAPACITY``
spans a session; past it spans are dropped and counted
(``trace.dropped``).  Nothing is written anywhere.

**Counters** (:func:`count`, :func:`counters`) are always on: plain sums
under a lock, where they are cheap (a kernel launch) or cold (a build).
The port counts ``kernel.launches.<library>`` (every hand-written
launch, in ``kernels.ops.launch``), ``kernel.builds`` / ``kernel.build_s``
(``nvcc``), ``kernel.loads`` / ``kernel.load_s`` (``ctypes.CDLL``),
``engine.build_s`` (engine layouts; the engine cache counts the builds as
misses), ``engine.h2d_bytes`` (literals copied to the card) and
``engine.d2h_bytes`` (results copied back in ``infer_padded``'s numpy
path).

**The profiler's clock.**  ``torch.profiler`` gives its events in
microseconds after ``prof.profiler.kineto_results.trace_start_ns()``,
which is wall-clock time (``time.time_ns()``).  A session takes the
offset between the two clocks when it starts; :func:`to_profiler_us`
puts a span's time on the profiler's axis, so a gap in the device's
activity can be joined to the span open at that moment.

The tracer is process-wide, as the profiler is.  Importing this module
chains :func:`_session_start` into torch's profiler-start hook
(``torch.autograd.profiler._run_on_profiler_start``), the only hook torch
calls when a profiler starts recording.  A torch without that hook
starts no session with a profiler, so spans of several profiles would
mix on a stale clock offset: there span sites ignore the profiler and
record only under :func:`enable`.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

__all__ = ["Span", "CAPACITY", "recording", "enable", "disable", "traced",
           "begin", "end", "count", "counters", "spans", "reset",
           "to_profiler_us"]

CAPACITY = 1 << 16          # spans kept a session


class Span(NamedTuple):
    """One recorded span; ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int              # index in spans() of the enclosing span, or -1
    thread: int              # threading.get_ident()
    call_id: int             # shared by every span of one outermost call
    attrs: dict | None


# a record: [name, start, end, parent, thread, call id, attrs, index]
_START, _END, _CALL, _INDEX = 1, 2, 5, 7

_enabled = False
_session = 0
_records: list = []
_offset_ns = 0              # time.time_ns() - perf_counter_ns() at start
_call_ids = itertools.count(1)
_tls = threading.local()    # .session, .stack: this thread's open records
_lock = threading.Lock()
_counters: dict = {}


def recording() -> bool:
    """Whether span sites record now."""
    return _flag._is_profiler_enabled or _enabled


def _session_start() -> None:
    global _records, _session, _offset_ns
    with _lock:
        _records = []
        _session += 1
        _offset_ns = time.time_ns() - time.perf_counter_ns()


def enable() -> None:
    """Record spans from now on, profiler or not, in a new session."""
    global _enabled
    _session_start()
    _enabled = True


def disable() -> None:
    """Stop recording spans outside a profiler (the session's spans stay
    readable)."""
    global _enabled
    _enabled = False


def _open(name: str, attrs) -> list:
    tls = _tls
    if getattr(tls, "session", None) != _session:
        tls.session, tls.stack = _session, []
    stack = tls.stack
    if stack:
        parent, call = stack[-1][_INDEX], stack[-1][_CALL]
    else:
        parent, call = -1, next(_call_ids)
    rec = [name, 0, None, parent, threading.get_ident(), call, attrs, -1]
    with _lock:
        if len(_records) < CAPACITY:
            rec[_INDEX] = len(_records)
            _records.append(rec)
        else:
            _counters["trace.dropped"] = _counters.get("trace.dropped",
                                                       0) + 1
    stack.append(rec)
    rec[_START] = time.perf_counter_ns()
    return rec


def begin(name: str, attrs: dict | None = None):
    """Open span ``name`` on this thread → a token for :func:`end`
    (``None`` when not recording)."""
    if not (_flag._is_profiler_enabled or _enabled):
        return None
    return _open(name, attrs)


def end(token) -> None:
    """Close the span ``token`` opened, and any span left open inside it
    (one whose code raised before its ``end``)."""
    if token is None:
        return
    token[_END] = time.perf_counter_ns()
    stack = getattr(_tls, "stack", None)
    if stack:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is token:
                del stack[i:]
                break


def traced(name: str, **attrs):
    """Decorator: each call of the function is span ``name`` with the
    fixed ``attrs``."""
    attrs = attrs or None

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_flag._is_profiler_enabled or _enabled):
                return fn(*args, **kwargs)
            rec = _open(name, attrs)
            try:
                return fn(*args, **kwargs)
            finally:
                end(rec)
        return wrapper
    return deco


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def spans() -> list[Span]:
    """The spans of the last recording session, in the order they opened
    (``parent`` indexes this list)."""
    with _lock:
        return [Span(*r[:_INDEX]) for r in _records]


def reset() -> None:
    """Drop every span (a new session starts) and zero every counter."""
    _session_start()
    with _lock:
        _counters.clear()


def to_profiler_us(t_ns: int, trace_start_ns: int) -> float:
    """A span time of the last session on the axis of ``torch.profiler``'s
    events: microseconds after ``trace_start_ns``
    (``prof.profiler.kineto_results.trace_start_ns()``)."""
    return (t_ns + _offset_ns - trace_start_ns) / 1e3


class _NoProfiler:
    """The flag span sites read where a profiler starts no session."""

    _is_profiler_enabled = False


def _chain_profiler_start(mod=_profiler):
    """Chain :func:`_session_start` into ``mod``'s profiler-start hook →
    the object whose ``_is_profiler_enabled`` span sites read: ``mod``
    where the hook is chained, :class:`_NoProfiler` where it is
    missing."""
    start = getattr(mod, "_run_on_profiler_start", None)
    if start is None:
        return _NoProfiler
    if not getattr(start, "starts_trace_session", False):
        def run_on_profiler_start():
            start()
            _session_start()

        run_on_profiler_start.starts_trace_session = True
        mod._run_on_profiler_start = run_on_profiler_start
    return mod


_flag = _chain_profiler_start()
