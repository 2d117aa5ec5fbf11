"""The request generator: the same seed gives the same requests, and every
seed the same spread of lengths."""

from __future__ import annotations

import numpy as np
import pytest

from lspbench import traffic
from lspbench.tests.conftest import tiny_mix

SEED = 2 ** 31 + 977


@pytest.mark.parametrize("name", ["offline_10s", "serve_short"])
def test_the_same_seed_gives_the_same_requests(name):
    mix = tiny_mix(name, pool=4)
    a, b = traffic.pool(mix, SEED), traffic.pool(mix, SEED)
    assert a == b
    np.testing.assert_array_equal(a[1].audio(), b[1].audio())
    c = traffic.pool(mix, SEED + 1)
    assert not np.array_equal(a[1].audio(), c[1].audio())


def test_stratified_lengths_fill_every_stratum_in_a_seeded_order():
    mix = tiny_mix("serve_short", pool=32)
    lo, hi = mix["lengths"]["low"], mix["lengths"]["high"]
    for seed in (1, SEED):
        secs = [r.seconds for r in traffic.pool(mix, seed)]
        strata = sorted(int((s - lo) / (hi - lo) * 32) for s in secs)
        assert strata == list(range(32))
    assert [r.seconds for r in traffic.pool(mix, 1)] != [r.seconds for r in traffic.pool(mix, 2)]


def test_the_warm_up_covers_every_bucket_the_lengths_reach():
    assert traffic.warm_seconds(tiny_mix("serve_short")) == [1.0, 2.0, 3.0, 4.0]
    assert traffic.warm_seconds(tiny_mix("offline_10s")) == [10.0]


def test_the_audio_is_speech_like():
    a = traffic.pool(tiny_mix("serve_short"), SEED)[0].audio()
    assert a.dtype == np.float32 and np.abs(a).max() <= 1.0
    spec = np.abs(np.fft.rfft(a))
    freqs = np.fft.rfftfreq(len(a), 1 / 16000)
    speech_band = spec[(freqs > 80) & (freqs < 4000)].sum() / spec.sum()
    assert speech_band > 0.6  # voiced energy where speech has it
    env = np.abs(a[: len(a) // 160 * 160]).reshape(-1, 160).max(axis=1)
    assert np.percentile(env, 10) < 0.25 * env.max()  # syllables rise and decay


def test_the_check_takes_the_longest_request_and_seeded_others():
    mix = tiny_mix("serve_short", pool=32, check_requests=6)
    reqs = traffic.pool(mix, SEED)
    pos = traffic.checked_positions(SEED, reqs, 6)
    assert len(set(pos)) == 6 and max(range(32), key=lambda k: reqs[k].seconds) in pos
    assert pos == traffic.checked_positions(SEED, reqs, 6)
