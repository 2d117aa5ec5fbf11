"""The program's request traces of the measured window, for the readers of
program spans and counters (``livespeechportraits_torch.utils.profiling``).

The harness calls ``Predictor.predict`` once for each warm-up request, then
once for each of the window's (``ctx.records``), then once for each traced
one (``ctx.traced``), and the program keeps one trace a call in its ring
``profiling.REQUESTS``.  The window is the ``len(ctx.records)`` traces just
before the last ``len(ctx.traced)``; each must have returned the frames its
record counts (0 for a failed call) and failed where it failed.  A reader
reads only these: untraced requests, which the profiler cannot slow."""


def window(ctx):
    """The window's traces in order, or None where the program keeps no
    ring (one that predates it), the ring is short, or a trace and its
    record disagree."""
    try:
        from livespeechportraits_torch.utils import profiling
    except ImportError:
        return None
    ring = list(getattr(profiling, "REQUESTS", ()))
    n, k = len(ctx.records), len(ctx.traced)
    if not n or len(ring) < n + k:
        return None
    win = ring[len(ring) - n - k:len(ring) - k]
    for t, r in zip(win, ctx.records):
        if (t.counters.get("frames_returned", 0) != r.nframe
                or (t.error is None) != (r.error is None)):
            return None
    return win


def _ok(ctx):
    return [t for t in window(ctx) or () if t.error is None]


def device_ms_per(ctx, span: str, counter: str):
    """The window's requests' ``span`` device ms summed, over their
    ``counter`` summed; None where a request has no device time for it (the
    CPU, or a program without the span)."""
    ok = _ok(ctx)
    ms = [getattr(t.find(span), "device_ms", None) for t in ok]
    n = sum(t.counters.get(counter, 0) for t in ok)
    if not ok or None in ms or not n:
        return None
    return sum(ms) / n


def share(ctx, useful: str, spent: str):
    """100 × the window's requests' ``useful`` counter summed over their
    ``spent`` counter summed, in %."""
    ok = _ok(ctx)
    n = sum(t.counters.get(spent, 0) for t in ok)
    return 100.0 * sum(t.counters.get(useful, 0) for t in ok) / n if n else None
