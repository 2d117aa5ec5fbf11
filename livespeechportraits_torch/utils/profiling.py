"""Tracing and timing hooks.

Counterpart of ``livespeechportraits_tpu/utils/profiling.py``: ``trace``
(here around ``torch.profiler``, with the CPU and, where the build has it,
the CUDA activity) and ``link_probe``, the device -> host link's round trip
and rate.

The port's own trace is a request's: ``serve.Predictor.predict`` opens a
``RequestTrace`` (``request``), kept in the ring ``REQUESTS``, and each
layer records its spans and counters into ``current()`` where its work
happens:

- serve (``Predictor.predict``): the span ``predict``, the counter
  ``frames_returned``;
- the motion half (``animate.compute_motion(fused=True)`` and
  ``motion_graph.MotionGraphs.run``): ``motion`` and its children
  ``motion.g1``, ``motion.decode``, ``motion.g3`` and ``motion.capture`` (a
  graph captured inside the request); ``decode_steps``, ``graph_captures``;
- the renderer (``animate.render_frames``): ``render`` and ``render.tail``;
  ``frames_rendered``, ``folded_bn_skipped`` (the BatchNorm layers that BN
  folding left at the identity, which the forwards skipped).

``AnimateResult.stage_ms`` reads its ``motion``, ``render_device`` and
``render`` entries off the spans ``motion``, ``render`` and
``render.tail``.  Spans are stamped with ``time.time_ns()``, the Unix-epoch
clock torch.profiler stamps its host records with, so a span lines up with
a profiler trace's records (``trace(log_dir)`` writes both).  On a card the
device time of ``motion``, its three children and ``render`` comes from
CUDA events recorded on the current stream beside the work, resolved to
floats after the render's synchronize: no extra synchronization, and no
event outlives its request.  The spans are the program's own and not
profiler ranges: a ``record_function`` range around device work yields a
device record of its own in a trace.

torch.profiler on the card has been seen to drop device records, sometimes
a whole trace's.  ``traced`` therefore times the traced window with CUDA
events as well, and ``coverage`` sets the trace's device busy time beside
that wall: a table built on a trace whose busy time falls more than 10 %
short of the wall says so, and is not presented as whole.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

# A trace's device busy time below this share of the CUDA-event wall of the
# same window is reported as partial.
COVERAGE_MIN = 0.9

# Every Predictor.predict call's trace, in call order (failed calls too).
REQUESTS: "collections.deque[RequestTrace]" = collections.deque(maxlen=1024)
_IDS = itertools.count()
_CURRENT: "contextvars.ContextVar[Optional[RequestTrace]]" = contextvars.ContextVar(
    "lsp_request", default=None)


@dataclass
class Span:
    """One span of a request: host start and end in ns on the profiler's
    clock, and ``device_ms``, the time between the CUDA events that bracket
    its work (None on the CPU or where none bracket it)."""

    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: Optional[int] = None
    device_ms: Optional[float] = None
    # (start, end) event pairs until resolved, one a device the work ran on
    events: list = field(default_factory=list, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def close(self) -> float:
        """End the span now; its host ms."""
        self.end_ns = time.time_ns()
        return self.host_ms

    def time_device(self, start: Optional["torch.cuda.Event"],
                    end: Optional["torch.cuda.Event"]) -> None:
        """Time the span's device work between two events of
        ``RequestTrace.mark`` on one device (nothing where either is None)."""
        if start is not None and end is not None:
            self.events.append((start, end))


@dataclass
class RequestTrace:
    """One request's spans and counters, and its error if it failed.
    ``timed``: whether ``mark`` records CUDA events (a request's trace)."""

    id: int
    spans: List[Span] = field(default_factory=list)
    counters: collections.Counter = field(default_factory=collections.Counter)
    error: Optional[str] = None
    timed: bool = True

    def begin(self, name: str, parent: Optional[str] = None) -> Span:
        span = Span(name, parent, time.time_ns())
        self.spans.append(span)
        return span

    def add(self, name: str, parent: Optional[str], start_ns: int, end_ns: int,
            events: tuple = (None, None)) -> Span:
        span = Span(name, parent, start_ns, end_ns)
        span.time_device(*events)
        self.spans.append(span)
        return span

    def find(self, name: str) -> Optional[Span]:
        """The first span named ``name``."""
        return next((s for s in self.spans if s.name == name), None)

    def open_span(self, name: str) -> Optional[Span]:
        """The last span named ``name`` that has not ended: the span a
        lower layer's call runs in."""
        return next((s for s in reversed(self.spans) if s.name == name and s.end_ns is None),
                    None)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def mark(self, device: torch.device) -> Optional["torch.cuda.Event"]:
        """A timing event recorded now on the device's current stream; None
        on the CPU or outside a request."""
        if not self.timed or device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event

    def resolve(self) -> None:
        """The device ms of every span with events, once the devices have
        synchronized past them (the longest over a span's devices; None if
        an event has not completed); the events are dropped."""
        for span in self.spans:
            if span.events:
                done = [a.elapsed_time(b) for a, b in span.events if b.query()]
                span.device_ms = max(done) if len(done) == len(span.events) else None
                span.events = []

    def finish(self) -> None:
        """End the spans left open (where a failed call stopped) and drop
        the events not resolved."""
        now = time.time_ns()
        for span in self.spans:
            if span.end_ns is None:
                span.end_ns = now
            span.events = []


def current() -> RequestTrace:
    """The trace of the request this thread serves; outside one, a fresh
    trace that nothing keeps and that records no CUDA events (its spans
    still time the caller's ``stage_ms``)."""
    trace_ = _CURRENT.get()
    return trace_ if trace_ is not None else RequestTrace(-1, timed=False)


@contextlib.contextmanager
def request() -> Iterator[RequestTrace]:
    """A request's trace over the block: appended to ``REQUESTS`` on entry,
    the block's ``current()``, its span ``predict`` from entry to exit, and
    the error the block raised, if any."""
    req = RequestTrace(next(_IDS))
    REQUESTS.append(req)
    token = _CURRENT.set(req)
    req.begin("predict")
    try:
        yield req
    except BaseException as e:
        req.error = f"{type(e).__name__}: {e}"
        raise
    finally:
        req.finish()
        _CURRENT.reset(token)


def _write_requests(requests: Iterable[RequestTrace], path: str, base_ns: int) -> None:
    """The requests' spans as a Chrome trace: one track a request, ``ts`` in
    µs from ``base_ns`` (a profiler trace's ``baseTimeNanoseconds``, so the
    two files share one timeline), each span's parent and ``device_ms`` in
    its args, and the counters and error in the ``predict`` span's."""
    events = []
    for req in requests:
        tid = f"request {req.id}"
        events.append({"ph": "M", "name": "thread_name", "pid": "lsp requests", "tid": tid,
                       "args": {"name": tid}})
        for s in req.spans:
            args = {"parent": s.parent, "device_ms": s.device_ms}
            if s.parent is None:
                args.update(counters=dict(req.counters), error=req.error)
            events.append({"ph": "X", "name": s.name, "pid": "lsp requests", "tid": tid,
                           "ts": (s.start_ns - base_ns) / 1e3, "dur": s.host_ms * 1e3,
                           "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns}, f)


def _base_ns(chrome_trace: str) -> int:
    """A torch.profiler Chrome trace's ``baseTimeNanoseconds`` (written
    before its events), else 0."""
    with open(chrome_trace) as f:
        m = re.search(r'"baseTimeNanoseconds":\s*(\d+)', f.read(4096))
    return int(m.group(1)) if m else 0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator["torch.profiler.profile"]:
    """torch.profiler over the block, CPU and (where the build has it) CUDA
    activities; yields the profiler (``events()``, ``key_averages()``).
    With log_dir, the Chrome trace is written to log_dir/trace.json and the
    spans of the requests made in the block to log_dir/program.json, on the
    same timeline."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    last = REQUESTS[-1].id if REQUESTS else -1
    with profile(activities=activities) as prof:
        yield prof
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        _write_requests([r for r in REQUESTS if r.id > last],
                       os.path.join(log_dir, "program.json"), _base_ns(path))


def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"this measures a CUDA device; got {dev} (no CPU stand-in)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    return dev


def traced(fn: Callable[[], object], device, iters: int = 1) -> Tuple[list, float]:
    """Run fn() iters times under ``trace`` on a CUDA device, timed by CUDA
    events around the same window.  Returns (the trace's events, host and
    device, the CUDA-event wall in ms of the iters calls)."""
    dev = _cuda(device)
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with trace() as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
    return list(prof.events()), start.elapsed_time(end)


def device_events(all_events: Iterable) -> list:
    return [e for e in all_events if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_ms(events: Iterable) -> float:
    """Device busy time: the union of the device events' intervals, ms."""
    total, start, end = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e3


def _label(event, ops: Dict[int, object]) -> Optional[str]:
    """The innermost profiler label ("lsp::...") around the host op that
    launched a device event, through the profiler's correlation id."""
    op = ops.get(getattr(event, "linked_correlation_id", 0))
    while op is not None:
        if op.name.startswith("lsp::"):
            return op.name
        op = op.cpu_parent
    return None


def family_ms(all_events: Sequence, families: Sequence[Tuple[str, Sequence[str]]]
              ) -> Dict[str, float]:
    """Device ms by family, over a trace's events (host and device): a
    device event goes to the first family that names its launching host
    op's label ("lsp::...", see _label) or a substring of its own name, else
    to "other"."""
    ops = {e.id: e for e in all_events if e.device_type == torch.autograd.DeviceType.CPU}
    out = {name: 0.0 for name, _ in families}
    out["other"] = 0.0
    for e in all_events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        label = _label(e, ops)
        fam = next((name for name, keys in families
                    if any(k == label or k in e.name for k in keys)), "other")
        out[fam] += e.time_range.elapsed_us() / 1e3
    return out


def coverage(all_events: List, wall_ms: float) -> Dict[str, object]:
    """The trace's device busy time beside the CUDA-event wall of the same
    window, and whether the table built on it may be read as whole."""
    events = device_events(all_events)
    busy = busy_ms(events)
    share = busy / wall_ms if wall_ms > 0 else 0.0
    out: Dict[str, object] = {"device_records": len(events), "trace_busy_ms": busy,
                              "event_wall_ms": wall_ms, "busy_share_of_wall": share,
                              "trace_whole": share >= COVERAGE_MIN}
    if share < COVERAGE_MIN:
        out["note"] = (f"the trace's device time is {share:.1%} of the CUDA-event wall of the "
                       "same window: the profiler dropped device records or the device idled; "
                       "the table is partial")
    return out


def link_probe(device="cuda", iters: int = 4) -> Dict[str, float]:
    """The device -> host link of a CUDA device: the round trip of a 1-byte
    fetch, and the MB/s of a 4 MiB fetch into pinned and into pageable host
    memory, each corrected for that round trip (medians over iters - 1
    fetches; the first is a warm-up).  Every fetch reads fresh random
    bytes made on the device from an explicit torch.Generator: a constant
    buffer could be compressed by a relay on the way, and fetching one
    tensor twice may measure a host copy, not the link.  A CPU device
    raises: there is no link to measure."""
    dev = _cuda(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = 4 << 20
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(n, dtype=torch.uint8)
    tiny_host = torch.empty(1, dtype=torch.uint8, pin_memory=True)

    def fresh(size: int) -> torch.Tensor:
        t = torch.randint(0, 256, (size,), generator=gen, device=dev, dtype=torch.uint8)
        torch.cuda.synchronize(dev)
        return t

    def fetch(dst: torch.Tensor, src: torch.Tensor) -> float:
        t0 = time.perf_counter()
        dst.copy_(src)  # a blocking device -> host copy
        return time.perf_counter() - t0

    rtts, pins, pages = [], [], []
    for i in range(max(2, iters)):
        rtt = fetch(tiny_host, fresh(1))
        pin = fetch(pinned, fresh(n))
        page = fetch(pageable, fresh(n))
        if i > 0:
            rtts.append(rtt)
            pins.append(pin)
            pages.append(page)
    rtt = float(np.median(rtts))

    def mbps(times: List[float]) -> float:
        return n / 1e6 / max(float(np.median(times)) - rtt, 1e-9)

    return {"link_rtt_ms": rtt * 1e3, "link_pinned_mbps": mbps(pins),
            "link_pageable_mbps": mbps(pages), "link_probe_bytes": n}
