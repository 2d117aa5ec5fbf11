"""The one generator of requests: a traffic mix's parameters and a seed ->
the requests of a run.

A mix (``lspbench/traffic/<name>.json``) gives the loop (``closed``: one
caller sends the next request when the last has returned), the request
lengths (``fixed``, or ``stratified_uniform`` over [low, high]: one length
drawn in each of ``pool`` equal strata, so every seed sends the same spread
of lengths in another order), the pool of distinct requests the caller
cycles through, the Predictor's arguments and how many requests and frames
the check and the trace take.  Each request's audio is speech-like
(``lspbench/speech.py``), from (seed, its index).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from lspbench import speech


@dataclass(frozen=True)
class Request:
    index: int  # in the pool
    seconds: float
    seed: int

    def audio(self) -> np.ndarray:
        return speech.speech(self.seconds, np.random.default_rng([self.seed, self.index]))


def pool(mix: dict, seed: int) -> List[Request]:
    """The mix's distinct requests, in the order the caller sends them."""
    n = int(mix["pool"])
    lengths = mix["lengths"]
    rng = np.random.default_rng([seed, 0x7A11])
    if lengths["dist"] == "fixed":
        secs = [float(lengths["seconds"])] * n
    elif lengths["dist"] == "stratified_uniform":
        lo, hi = float(lengths["low"]), float(lengths["high"])
        secs = [lo + (hi - lo) * (k + u) / n for k, u in enumerate(rng.random(n))]
        secs = [secs[k] for k in rng.permutation(n)]
    else:
        raise ValueError(f"unknown length distribution {lengths['dist']!r}")
    if mix.get("loop") != "closed" or int(mix.get("callers", 1)) != 1:
        raise ValueError("this generator serves a closed loop of one caller")
    return [Request(k, round(s * 16000) / 16000, seed) for k, s in enumerate(secs)]


def warm_seconds(mix: dict) -> List[float]:
    """One audio length for each bucket the mix's lengths can land in."""
    b = float(mix["bucket_seconds"])
    lengths = mix["lengths"]
    lo, hi = ((lengths["seconds"],) * 2 if lengths["dist"] == "fixed"
              else (lengths["low"], lengths["high"]))
    first, last = max(1, math.ceil(lo / b - 1e-9)), math.ceil(hi / b - 1e-9)
    return [k * b for k in range(first, last + 1)]


def checked_positions(seed: int, reqs: List[Request], count: int) -> List[int]:
    """The window positions whose frames the check holds against the
    reference, all of them: the first pass over the pool's longest request,
    and ``count`` - 1 more of the first pass drawn from the seed."""
    n = len(reqs)
    longest = max(range(n), key=lambda k: reqs[k].seconds)
    rest = [int(p) for p in np.random.default_rng([seed, 0xC4EC]).permutation(n) if p != longest]
    return sorted([longest] + rest[:max(0, min(count, n) - 1)])
