"""Tracing and profiling (counterpart of the JAX ``utils/profiling.py``).

One in-memory span recorder, with two entry points that the port calls at
its layer boundaries:

  * :func:`op_scope` opens ``ppt.<name>`` around a public op and around
    its autograd backward (``ppt.<name>.backward``);
  * :func:`annotate` opens a host phase (the train step's ``train.*``
    spans; the layers' ``layers.*``), and an NVTX range besides.

Off by default: a span site then costs one module-level flag test and
returns one shared no-op context (no ``record_function``, no NVTX, no
clock read, no allocation). Spans are no-ops while torch traces the code
(``torch.compiler.is_compiling()``), so an export sees none.

The operator turns the recorder on with :func:`recording` (``with
profiling.recording() as rec: ...``; ``rec.spans`` holds every span when
the block ends) or with :func:`trace`, which records around a
torch.profiler run and writes the Chrome trace, where the ``ppt.*`` and
``train.*`` ranges then show. On, a span keeps a record in memory (a few
microseconds; nothing is written during a step) and, while a profiler
runs, opens a ``record_function`` range too. A span records its name,
its start and end in ns on ``time.time_ns()`` (CLOCK_REALTIME, the clock
on which CUPTI stamps the runtime calls and device items of a
torch.profiler run), its parent, its thread (``threading.get_ident()``)
and its step (the count of root spans, which every span of one step
shares). Each thread keeps its own stack of open spans; a span opened
on a thread with none open (the autograd engine runs a CUDA backward on a
device thread of its own) takes as parent the innermost span open at that
moment on the thread that opened the open root span.

:func:`attribute` reads a CUDA profile against the spans: device seconds
per span, self seconds, the idle gaps labelled by what the host was
doing, and the synchronising runtime calls::

    with profiling.recording() as rec, profiling.trace(log_dir) as prof:
        step(batch)
    att = profiling.attribute(prof, rec.spans)
"""

from __future__ import annotations

import bisect
import contextlib
import os
import re
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_clock = time.time_ns
_REC = None  # the open Recorder, or None: the one test a span site makes


class _NoOp:
    """The shared context a span site returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()


@dataclass
class Span:
    """One recorded span; ``parent`` indexes the recorder's list (-1 for a
    root), ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    parent: int
    thread: int
    step: int
    end_ns: int | None = None


class Recorder:
    """Spans of one recording, in the order they opened."""

    def __init__(self):
        self.spans: list[Span] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._root_stack = None  # the open root span's thread's stack
        self._steps = 0
        self._nvtx = torch.cuda.is_available()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str) -> int:
        stack = self._stack()
        with self._lock:
            if stack:
                parent = stack[-1]
            else:
                root = self._root_stack
                top = root[-1:] if root is not None else []
                if top:  # a root is open on another thread
                    parent = top[0]
                else:
                    parent, self._root_stack = -1, stack
                    self._steps += 1
            step = (self.spans[parent].step if parent >= 0
                    else self._steps - 1)
            idx = len(self.spans)
            self.spans.append(Span(name, _clock(), parent,
                                   threading.get_ident(), step))
        stack.append(idx)
        return idx

    def close(self, idx: int) -> None:
        self.spans[idx].end_ns = _clock()
        stack = self._stack()
        stack.pop()
        if not stack and self._root_stack is stack:
            self._root_stack = None


class _Open:
    """A span while the recorder is on: the recorder's record, a
    ``record_function`` range while a profiler runs (it shows in the
    profiler's trace; without one it would only cost) and, for
    :func:`annotate`, an NVTX range."""

    __slots__ = ("rec", "name", "nvtx", "idx", "rf")

    def __init__(self, rec: Recorder, name: str, nvtx: bool):
        self.rec, self.name, self.nvtx = rec, name, nvtx and rec._nvtx

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.idx = self.rec.open(self.name)  # stamped after the ranges open
        return self

    def __exit__(self, *exc):
        self.rec.close(self.idx)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _span(name: str, nvtx: bool):
    rec = _REC
    if rec is None or torch.compiler.is_compiling():
        return _NOOP
    return _Open(rec, name, nvtx)


def annotate(name: str):
    """Host phase ``name`` as a span (and an NVTX range on a card) while
    the recorder is on; the shared no-op otherwise."""
    if _REC is None:
        return _NOOP
    return _span(name, True)


def op_scope(name: str):
    """Span ``ppt.<name>`` of one op while the recorder is on; the shared
    no-op otherwise."""
    if _REC is None:
        return _NOOP
    return _span("ppt." + name, False)


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the block; yields the :class:`Recorder`,
    whose ``spans`` are complete when the block ends. Inside an open
    recording it yields that one."""
    global _REC
    if _REC is not None:
        yield _REC
        return
    rec = _REC = Recorder()
    try:
        yield rec
    finally:
        _REC = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA when a card is present),
    with the recorder on, and write a Chrome trace (``trace_<pid>_<ns>.json``,
    viewable in Perfetto or chrome://tracing) into ``log_dir``. Yields the
    profiler, whose ``key_averages()`` summarize the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# attribution of a CUDA profile to the spans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Event:
    """One record of a CUDA profile: a device item (kernel, copy, fill;
    ``device`` True) or a runtime call on the host, with its thread; the
    two share ``corr`` when the call launched the item."""

    name: str
    start_ns: int
    end_ns: int
    corr: int
    device: bool
    thread: int = 0


def _tid32(t: int) -> int:
    """A thread id as CUPTI stores it: the low 32 bits, signed."""
    return ((t + 2**31) % 2**32) - 2**31


def events(prof) -> list[Event]:
    """The device items and runtime calls of a torch.profiler run (the
    raw kineto records: a runtime call's thread is in its
    ``device_resource_id``; user annotations and profiler overhead are
    left out)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                out.append(Event(name, e.start_ns(), e.end_ns(),
                                 e.correlation_id(), True))
        elif (name.startswith("cu") and e.correlation_id() > 0
              and e.device_resource_id() != 0):
            out.append(Event(name, e.start_ns(), e.end_ns(),
                             e.correlation_id(), False,
                             _tid32(e.device_resource_id())))
    return out


_SYNC = re.compile(r"^cu\w*Synchronize$")


def _end(span: Span) -> int:
    """A span's end; one still open when the recording ended runs on."""
    return 2**63 if span.end_ns is None else span.end_ns


class _Innermost:
    """The innermost of a set of spans open at a time: the spans' bounds
    swept once into segments, each owned by the top of the stack."""

    def __init__(self, spans, ids):
        marks = sorted([(spans[i].start_ns, 1, i) for i in ids]
                       + [(_end(spans[i]), 0, i) for i in ids])
        self.bounds, self.owner, open_ = [], [], []
        for t, is_start, i in marks:
            if is_start:
                open_.append(i)
            else:
                open_.remove(i)
            top = open_[-1] if open_ else -1
            if self.bounds and self.bounds[-1] == t:
                self.owner[-1] = top
            else:
                self.bounds.append(t)
                self.owner.append(top)

    def at(self, t: int) -> int:
        k = bisect.bisect_right(self.bounds, t) - 1
        return self.owner[k] if k >= 0 else -1


@dataclass
class Attribution:
    """What :func:`attribute` read. Times in seconds; ``gaps`` are
    (label, seconds, name of the item that ends it), longest first;
    ``syncs`` (call, seconds, span name or None)."""

    spans: list
    inclusive: list
    self_s: list
    unattributed_s: float
    busy_s: float
    window_s: float
    gaps: list = field(default_factory=list)
    syncs: list = field(default_factory=list)

    def _outermost(self, names) -> list[int]:
        """Spans named in ``names`` with no ancestor named in them."""
        names, out = set(names), []
        for i, s in enumerate(self.spans):
            if s.name not in names:
                continue
            p = s.parent
            while p >= 0 and self.spans[p].name not in names:
                p = self.spans[p].parent
            if p < 0:
                out.append(i)
        return out

    def device_s(self, *names: str) -> float:
        """Device seconds under the spans of these names, each item once."""
        return sum(self.inclusive[i] for i in self._outermost(names))

    def self_device_s(self, *names: str) -> float:
        """Device seconds of the spans of these names less their children's."""
        names = set(names)
        return sum(self.self_s[i] for i, s in enumerate(self.spans)
                   if s.name in names)

    def host_s(self, *names: str) -> float:
        """Host seconds of the spans of these names (closed ones)."""
        return sum((self.spans[i].end_ns - self.spans[i].start_ns) / 1e9
                   for i in self._outermost(names)
                   if self.spans[i].end_ns is not None)

    def calls(self, *names: str) -> int:
        return sum(1 for s in self.spans if s.name in names)

    def names(self) -> list[str]:
        return sorted({s.name for s in self.spans})


def attribute(prof, spans, since_ns: int | None = None) -> Attribution:
    """Read a torch.profiler run with CUDA activity (or a list of
    :class:`Event`) against the recorder's ``spans``.

    Each device item goes to the innermost span open on its launching
    thread when its runtime call was made (the two share a correlation
    id), or, where that thread had none open, to the innermost span then
    open on the thread of the open root span; an item with neither is
    ``unattributed_s``. Items that start before ``since_ns`` are left out.
    An idle gap between the window's start (``since_ns``, else the first
    item) and its last item is labelled by the item that ends it: where
    its launch came after the gap began (the host was behind), by the
    innermost span open at the gap's start on the launching thread (or the
    root's thread as above); otherwise "queued". The synchronising calls
    are ``cuda*Synchronize`` and the memcpy calls whose item copies device
    to host."""
    evs = prof if isinstance(prof, list) else events(prof)
    spans = list(spans)
    n = len(spans)
    by_thread: dict[int, list[int]] = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(_tid32(s.thread), []).append(i)
    inner = {t: _Innermost(spans, ids) for t, ids in by_thread.items()}
    roots = _Innermost(spans, [i for i, s in enumerate(spans)
                               if s.parent < 0])

    def span_at(thread: int, t: int) -> int:
        idx = inner[thread].at(t) if thread in inner else -1
        if idx < 0:
            r = roots.at(t)
            if r >= 0:
                idx = inner[_tid32(spans[r].thread)].at(t)
        return idx

    calls = {e.corr: e for e in evs if not e.device}
    items = sorted((e for e in evs if e.device
                    and (since_ns is None or e.start_ns >= since_ns)),
                   key=lambda e: e.start_ns)
    own = [0.0] * n
    unattributed = 0.0
    for e in items:
        call = calls.get(e.corr)
        idx = span_at(call.thread, call.start_ns) if call else -1
        if idx >= 0:
            own[idx] += (e.end_ns - e.start_ns) / 1e9
        else:
            unattributed += (e.end_ns - e.start_ns) / 1e9
    inclusive = list(own)
    for i in range(n - 1, -1, -1):  # a child opens after its parent
        if spans[i].parent >= 0:
            inclusive[spans[i].parent] += inclusive[i]

    gaps, busy = [], 0.0
    prev = since_ns if since_ns is not None else (
        items[0].start_ns if items else 0)
    w0 = prev
    for e in items:
        if e.start_ns > prev:
            call = calls.get(e.corr)
            if call is not None and call.start_ns > prev:
                idx = span_at(call.thread, prev)
                label = spans[idx].name if idx >= 0 else "(no span)"
            else:
                label = "queued" if call is not None else "(no launch)"
            gaps.append((label, (e.start_ns - prev) / 1e9, e.name))
            busy += (e.end_ns - e.start_ns) / 1e9
        elif e.end_ns > prev:
            busy += (e.end_ns - prev) / 1e9
        prev = max(prev, e.end_ns)
    gaps.sort(key=lambda g: -g[1])

    dtoh = {e.corr for e in items if "DtoH" in e.name}
    syncs = []
    for c in calls.values():
        if _SYNC.match(c.name) or (c.name.startswith("cudaMemcpy")
                                   and c.corr in dtoh):
            idx = span_at(c.thread, c.start_ns)
            syncs.append((c.name, (c.end_ns - c.start_ns) / 1e9,
                          spans[idx].name if idx >= 0 else None))
    return Attribution(spans=spans, inclusive=inclusive, self_s=own,
                       unattributed_s=unattributed, busy_s=busy,
                       window_s=(prev - w0) / 1e9, gaps=gaps, syncs=syncs)
