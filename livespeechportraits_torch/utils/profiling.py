"""Tracing and timing hooks.

Counterpart of ``livespeechportraits_tpu/utils/profiling.py``: ``trace``
(here around ``torch.profiler``, with the CPU and, where the build has it,
the CUDA activity), the ``Stopwatch`` that ``stage_ms`` dicts feed, and
``link_probe``, the device -> host link's round trip and rate.

torch.profiler on the card has been seen to drop device records, sometimes
a whole trace's.  ``traced`` therefore times the traced window with CUDA
events as well, and ``coverage`` sets the trace's device busy time beside
that wall: a table built on a trace whose busy time falls more than 10 %
short of the wall says so, and is not presented as whole.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

# A trace's device busy time below this share of the CUDA-event wall of the
# same window is reported as partial.
COVERAGE_MIN = 0.9


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator["torch.profiler.profile"]:
    """torch.profiler over the block, CPU and (where the build has it) CUDA
    activities; yields the profiler (``events()``, ``key_averages()``).
    With log_dir, the Chrome trace is written to log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities) as prof:
        yield prof
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Stopwatch:
    """Accumulating named-stage stopwatch."""

    def __init__(self) -> None:
        self.ms: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def report(self) -> str:
        if not self.ms:
            return "no stages recorded"
        total = sum(self.ms.values())
        denom = total or 1.0  # sub-resolution stages must not divide by 0
        lines = [f"{k}: {v:.1f} ms ({100 * v / denom:.0f}%)" for k, v in self.ms.items()]
        return " | ".join(lines) + f" | total {total:.1f} ms"


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
