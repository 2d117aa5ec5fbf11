"""motion half: stage_ms["motion"] (the host wall of the fused G1, G2 a
frame and G3) summed over the window's requests, over the frames returned."""


def read(ctx):
    ok = [r for r in ctx.records if r.error is None]
    frames = sum(r.nframe for r in ok)
    return sum(r.stage_ms["motion"] for r in ok) / frames if frames else None
