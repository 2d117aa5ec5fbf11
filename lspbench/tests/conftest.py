"""Fixtures of the benchmark's CPU tests: a tiny configuration of each kind
(32 px, the U-Net's depth cut to 5, a 256-row bank) and a working
directory, shared by the session, that holds the tiny subjects."""

from __future__ import annotations

import json
import os

import pytest
import torch

from lspbench import manifest

TINY = dict(image_size=32, n_downsample=5, bank_size=256)


def tiny_config(name: str, **extra) -> dict:
    with open(os.path.join(manifest.HERE, "configs", f"{name}.json")) as f:
        c = json.load(f)
    c.update({**TINY, "name": f"tiny_{name}", **extra})
    return c


def tiny_mix(name: str, **extra) -> dict:
    with open(manifest.traffic_path(name)) as f:
        mix = json.load(f)
    mix.update({"pool": 3, "check_requests": 2, "trace_requests": 1, **extra})
    return mix


@pytest.fixture(scope="session")
def workdir(tmp_path_factory):
    """A directory the harness's relative paths (build/lspbench/...) resolve
    in; the tests chdir into it."""
    torch.set_num_threads(2)
    return tmp_path_factory.mktemp("lspbench")


@pytest.fixture
def in_workdir(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    return workdir
