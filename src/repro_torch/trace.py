"""Spans of the serving path, off by default.

``span(name)`` marks one stretch of work on the thread that runs it. Off
(the default), it costs one check of a module flag and returns a shared
null context: no ``torch.profiler`` call, no CUDA event, no record.
``enable()`` turns the spans on and ``disable()`` off again; no
environment variable or flag does. On, a span

- enters ``torch.profiler.record_function(name)``, so it shows in any
  ``torch.profiler`` trace on the thread that ran it, on the clock of the
  device's kernels and copies (a profiler records threads other than the
  one that started it only when armed with ``profile_all_threads``);
- appends a ``Record`` (name, thread, host start and end from
  ``time.perf_counter``) to a bounded record (the oldest go first).

``engine_call(device)`` brackets one engine call. On a CUDA device, each
span given that device inside it records a timing event on the current
stream where it begins and one where it ends, and these pairs chain up
in order (the engine's ``engine.iter`` spans, one an iteration). At the
call's end an ``engine.iter_gap`` record, spanning the call on the host,
takes the device time from each iteration's last launch to the next
iteration's first, summed: how long the device waited on the engine's
host loop. Its ``device_ms`` is resolved once all its events have
completed, polled without waiting at the call's end (its last loop
condition has read the device, so they mostly have) and at each read:
tracing adds no synchronisation of its own.

``records(t0, t1)`` returns the records that ended in ``[t0, t1)`` on the
host clock. The serving thread and the dispatcher's phase-1 worker may
write the record at once.

The spans, each where its work is done:

==================  ===============  =========================================
span                thread           covers
==================  ===============  =========================================
admission.plan      serving          all of ``AdmissionQueue.plan``
admission.predict   serving          once a packing plan round: the
                                     deadline pass's depth estimates, none
                                     when no member has a deadline
dispatch.phase1     phase-1 worker   the engine call of phase 1 (or of the
                                     static engine) to its end event
dispatch.join       serving          the wait for phase 1 in
                                     ``QueryDispatcher._await``
engine.iter         the engine's     one iteration: stats tap, extend, merge,
                                     apply (worker in phase 1, serving
                                     thread in phase 2)
engine.iter_gap     the engine's     one an engine call on a card (above)
service.finalize    serving          ``ServingLoop._finalize_tail``: the
                                     stitch, the unpack and every delivery
service.unpack      serving          the result's copy to the host and
                                     ``unpack_levels`` (other kinds: the
                                     leaves' copy and slice)
==================  ===============  =========================================
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
import time

import torch

CAPACITY = 1 << 17  # records kept
PENDING = 1 << 12  # engine.iter_gap records awaiting their events

_on = False
_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=CAPACITY)
# (record, [(end event, start event), ...]) whose events have not all
# completed yet, oldest first
_pending: collections.deque = collections.deque()
_local = threading.local()  # the engine call open on this thread
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Record:
    """One span: host interval (``time.perf_counter``, s) and, for an
    ``engine.iter_gap``, its device time (ms) once resolved."""

    name: str
    thread: str
    t0: float
    t1: float
    device_ms: float | None = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, device: torch.device | None = None):
    """A context that records ``name`` when tracing is on; with a CUDA
    ``device``, inside an engine call, it is also one link of that call's
    chain of device intervals (module docstring)."""
    if not _on:
        return _OFF
    return _Span(name, device)


def engine_call(device: torch.device):
    """A context around one engine call: its iterations' device gaps go to
    one ``engine.iter_gap`` record (module docstring)."""
    if not _on:
        return _OFF
    return _EngineCall(device)


def records(t0: float = -math.inf, t1: float = math.inf) -> list[Record]:
    """The records that ended in ``[t0, t1)``, device times resolved where
    their events have completed."""
    with _lock:
        _resolve()
        return [r for r in _records if t0 <= r.t1 < t1]


def _event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _add(rec: Record, pairs: list | None = None) -> None:
    with _lock:
        _records.append(rec)
        if pairs is not None:
            if len(_pending) >= PENDING:
                _pending.popleft()  # its record keeps device_ms None
            _pending.append((rec, pairs))
            _resolve()


def _resolve() -> None:
    """Set ``device_ms`` of each pending record whose events have all
    completed (``Event.query`` polls; nothing waits). Holds ``_lock``."""
    keep = []
    for rec, pairs in _pending:
        if all(a.query() and b.query() for a, b in pairs):
            rec.device_ms = float(sum(a.elapsed_time(b) for a, b in pairs))
        else:
            keep.append((rec, pairs))
    _pending.clear()
    _pending.extend(keep)


class _Span:
    __slots__ = ("name", "_call", "_rf", "_ev0", "_t0")

    def __init__(self, name: str, device):
        self.name = name
        call = getattr(_local, "call", None)
        linked = (device is not None and device.type == "cuda"
                  and call is not None)
        self._call = call if linked else None

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self._call is not None:
            self._ev0 = _event(self._call.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._call is not None:
            self._call.links.append((self._ev0,
                                     _event(self._call.device)))
        t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        _add(Record(self.name, threading.current_thread().name, self._t0,
                    t1))
        return False


class _EngineCall:
    __slots__ = ("device", "cuda", "links", "_outer", "_t0")

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.links: list = []

    def __enter__(self):
        self._outer = getattr(_local, "call", None)
        # only a call on a card links its spans' device intervals
        _local.call = self if self.cuda else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _local.call = self._outer
        if self.cuda:
            gaps = [(a[1], b[0]) for a, b in zip(self.links, self.links[1:])]
            _add(Record("engine.iter_gap", threading.current_thread().name,
                        self._t0, t1), gaps)
        return False
