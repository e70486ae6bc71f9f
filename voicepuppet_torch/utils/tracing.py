"""Spans and counters of the port's serving and training paths.

``span(name, ...)`` marks one piece of work at a layer boundary (the
``vp.*`` names: ``vp.synthesize``, ``vp.coeff``, ``vp.render.chunk``,
``vp.render.drain_wait``, ``vp.drain.fetch_wait``, ``vp.drain.unpack``,
``vp.stream.coeff``, ``vp.stream.block``, ``vp.train.d_half``,
``vp.train.g_half``); ``count(name, n)`` adds to a counter
(``vp.frames.served``, ``vp.frames.padded``, ``vp.bn.fused``,
``vp.bn.eager``, ``vp.gru.fused``, ``vp.gru.eager``).
What a span does depends on what is open:

* nothing: one flag test, nothing allocated;
* a ``torch.profiler`` session: a host range like an op's (not a
  user-scope ``record_function``, whose copy on the device's timeline a
  trace would count as device work), so the span lies on the profiler's
  clock beside the device's kernels (and is an NVTX range under
  ``emit_nvtx``);
* a :func:`recording`: the span is kept in memory (name, thread, parent,
  request, size, host start and end by ``perf_counter_ns``, and with
  ``device=`` a CUDA device, the device time between two CUDA events
  recorded on its current stream at the span's ends, read only when the
  recording is summarised, so the serving path never synchronises for
  it).

``request`` is the id shared by the spans of one call or of one stream
(:func:`new_request`); a span given none takes its parent's.  The parent
is the innermost span open in the same thread, or the one passed as
``parent=`` where the work runs in another thread (the drain workers).

``profiler(**kw)`` is a ``torch.profiler.profile`` that records every
thread, so the drain workers' and the data workers' spans and ops land
in the trace::

    with tracing.profiler() as p:
        synth.synthesize(panel, pcm, identity)
    p.export_chrome_trace("serve.json")
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_active: Optional["Recording"] = None     # the open recording
_local = threading.local()                # .stack: this thread's open spans
_requests = itertools.count(1)


class _Off:
    """The span of a path nobody is watching: enters and exits."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def new_request() -> int:
    """A fresh request id: one per served call or per stream."""
    return next(_requests)


def span(name: str, request: Optional[int] = None,
         size: Optional[int] = None, device=None, parent=None):
    """A context manager around one piece of work (module docstring).
    ``device``: a ``torch.device`` whose work the span also times by CUDA
    events (only on a CUDA device, only while recording).  ``parent``: the
    span (as entered, or None) the work belongs to when it runs in
    another thread.  Entering gives the recorded span, or None."""
    if _active is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request, size, device, parent)


def current():
    """The innermost recorded span open in this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` of the open recording.  ``n`` may
    be an integer tensor of one element on any device: it is kept as it is
    and read when the counts are, so counting never waits for the
    device."""
    rec = _active
    if rec is not None:
        with rec.lock:
            if isinstance(n, torch.Tensor):
                rec.pending.append((name, n))
            else:
                rec.kept[name] = rec.kept.get(name, 0) + int(n)


def counting() -> bool:
    """Whether a recording is open, so that a count would be kept (for a
    count that costs work to form)."""
    return _active is not None


def cuda_event(device=None) -> "torch.cuda.Event":
    """A timing CUDA event recorded now on ``device``'s current stream
    (the current device's by default)."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Span:
    __slots__ = ("name", "request", "size", "device", "parent", "thread",
                 "index", "start_ns", "end_ns", "events", "_rf", "_rec")

    def __init__(self, name, request, size, device, parent):
        self.name = name
        self.request = request
        self.size = size
        self.device = device
        self.parent = parent
        self.index = None
        self.end_ns = None
        self.events = None
        self._rf = None
        self._rec = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            # a range of function scope, as an op's: a user-scope
            # ``record_function`` also lays a span over the device's
            # timeline, which a trace would count as device work
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        rec = _active
        if rec is None:
            return None
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if self.parent is None and stack:
            self.parent = stack[-1]
        if self.parent is not None and self.parent._rec is not rec:
            self.parent = None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.thread = threading.current_thread().name
        self._rec = rec
        with rec.lock:
            self.index = len(rec.spans)
            rec.spans.append(self)
        stack.append(self)
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            self.events = (cuda_event(dev), None)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            if self.events is not None:
                self.events = (self.events[0], cuda_event(self.device))
            self.end_ns = time.perf_counter_ns()
            _local.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def record(self) -> dict:
        device_ms = None
        if self.events is not None and self.events[1] is not None:
            self.events[1].synchronize()
            device_ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.index,
                "parent": None if self.parent is None else self.parent.index,
                "thread": self.thread, "request": self.request,
                "size": self.size, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device_ms": device_ms}


class Recording:
    """Spans and counters kept in memory while open (one at a time in a
    process).  ``summary()`` after close: ``{"spans": [...], "counts":
    {...}, "start_ns", "end_ns"}``, each span a plain dict (``name``,
    ``id``, ``parent`` id, ``thread``, ``request``, ``size``, host
    ``start_ns`` / ``end_ns``, ``device_ms`` or None), the spans that
    were still open at close left out."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[_Span] = []
        self.kept: Dict[str, int] = {}
        self.pending: List[tuple] = []      # (name, tensor) not yet read
        self.start_ns = self.end_ns = None
        self._summary = None

    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("a tracing recording is already open")
        self.start_ns = time.perf_counter_ns()
        _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = None
        self.end_ns = time.perf_counter_ns()
        return False

    @property
    def counts(self) -> Dict[str, int]:
        """The counters, the counts held on a device read in."""
        with self.lock:
            for name, n in self.pending:
                self.kept[name] = self.kept.get(name, 0) + int(n)
            self.pending.clear()
            return self.kept

    def summary(self) -> dict:
        if self._summary is None:
            counts = dict(self.counts)
            with self.lock:
                spans = [s.record() for s in self.spans
                         if s.end_ns is not None]
            self._summary = {"spans": spans, "counts": counts,
                             "start_ns": self.start_ns,
                             "end_ns": self.end_ns}
        return self._summary


def recording() -> Recording:
    """Keep every span and count until the block ends::

        with tracing.recording() as rec:
            synth.synthesize(...)
        rec.summary()
    """
    return Recording()


def profiler(**kw):
    """``torch.profiler.profile`` over every thread, with CPU and (where
    there is a card) CUDA activity unless ``activities`` is given."""
    from torch.profiler import ProfilerActivity, profile
    if "activities" not in kw:
        kw["activities"] = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    kw.setdefault("experimental_config", torch._C._profiler
                  ._ExperimentalConfig(profile_all_threads=True))
    return profile(**kw)
