"""renderer: stage_ms["render_device"] + stage_ms["render"] summed over the
window's requests, over the frames rendered (each request's padded to
whole render batches)."""


def read(ctx):
    ok = [r for r in ctx.records if r.error is None]
    batch = ctx.mix["render_batch"]
    rendered = sum(-(-r.nframe // batch) * batch for r in ok)
    if not rendered:
        return None
    return sum(r.stage_ms["render_device"] + r.stage_ms["render"] for r in ok) / rendered
