"""The end-to-end arithmetic: fps is every frame over the whole window, the
90th percentile is over every request, a failed one counting as missing."""

from __future__ import annotations

import math

from lspbench import manifest, run


def _cell(names):
    m = manifest.load()
    return manifest.Cell("x", 1, {}, {}, [x for x in m["end_to_end"] if x["name"] in names], [])


def test_fps_is_all_frames_over_all_the_time():
    recs = [run.Record(i, 10.0, 1000.0 + 500 * i, nframe=585) for i in range(4)]
    out = run._end_to_end(_cell({"fps", "setup_s"}), recs, window_s=7.5, setup_s=3.0)
    assert out["fps"]["value"] == 4 * 585 / 7.5  # not a mean of per-request rates
    assert out["setup_s"]["value"] == 3.0


def test_p90_is_the_nearest_rank_over_every_request():
    walls = [float(w) for w in range(1, 101)]
    recs = [run.Record(i, 2.0, w, nframe=100) for i, w in enumerate(walls)]
    out = run._end_to_end(_cell({"request_p90_ms"}), recs, window_s=60.0, setup_s=1.0)
    assert out["request_p90_ms"]["value"] == 90.0
    # halves of the window give other tails; the window's is over all requests
    assert run.p90(walls[:50]) != run.p90(walls)


def test_a_failed_request_counts_as_missing_the_tail():
    recs = [run.Record(i, 2.0, 100.0, nframe=100) for i in range(9)]
    recs.append(run.Record(9, 2.0, math.inf, error="RuntimeError: boom"))
    out = run._end_to_end(_cell({"request_p90_ms", "fps"}), recs, window_s=1.0, setup_s=1.0)
    assert out["request_p90_ms"]["value"] == 100.0
    recs[0] = run.Record(0, 2.0, math.inf, error="RuntimeError: boom")
    assert run.p90([r.wall_ms for r in recs]) == math.inf
    assert out["fps"]["value"] == 900.0
