"""transfer: stage_ms["render"], the last render batch's fetch to the host
and its decode, which each request waits for after the device has
finished, averaged over the window's requests."""


def read(ctx):
    ok = [r for r in ctx.records if r.error is None]
    return sum(r.stage_ms["render"] for r in ok) / len(ok) if ok else None
