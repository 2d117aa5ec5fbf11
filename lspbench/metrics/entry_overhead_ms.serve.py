"""serve: a request's wall less the program's own stages (the motion half,
the render loop and the last batch's fetch), averaged over the window's
requests: what Predictor.predict spends around animate()."""


def read(ctx):
    ok = [r for r in ctx.records if r.error is None]
    if not ok:
        return None
    return sum(r.wall_ms - r.stage_ms["motion"] - r.stage_ms["render_device"]
               - r.stage_ms["render"] for r in ok) / len(ok)
