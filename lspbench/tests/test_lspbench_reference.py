"""The subject the benchmark writes loads through the program's own path,
and the plain reference computes what the program computes (CPU, 32 px)."""

from __future__ import annotations

import os

import numpy as np
import torch

from lspbench import speech
from lspbench.reference import motion, nets, render, subject
from lspbench.tests.conftest import tiny_config


def test_the_subject_loads_strictly_and_the_reference_agrees(in_workdir):
    from livespeechportraits_torch.config import load_person_config
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.pipeline import animate, assets

    c = tiny_config("may_large_int8")
    root = os.path.join("build", "lspbench", "subjects", c["name"])
    subject.ensure_subject(c, root, "cpu")
    assert not subject.ensure_subject(c, root, "cpu")  # written once
    cfg = load_person_config(os.path.join(root, f"{c['name']}.yaml"), name=c["name"])
    # load_person_models loads every stage with strict=True
    cfg, person, models = assets.load_subject(cfg, c["image_size"], device="cpu")
    assert (cfg.feature2face.size, cfg.feature2face.n_downsample) == (c["size"], 5)

    A, sd = subject.read_subject(root, c, "cpu")
    audio = speech.speech(1.3, np.random.default_rng(3))
    lm, sh = motion.motion(c, A, sd, audio, seed=21, device="cpu")
    l2, s2, _, _, n = animate.compute_motion(cfg, person, models, audio, seed=21)
    assert n == len(lm)
    # pixels: float32 recurrences and the mouth head's gain, summed otherwise
    np.testing.assert_allclose(l2[:n].numpy(), lm, atol=0.05)
    np.testing.assert_allclose(s2[:n].numpy(), sh, atol=0.05)
    assert np.ptp(lm[:, 46:64], axis=0).max() > 0.5  # the mouth moves, in pixels

    with torch.no_grad():
        x = render.render_input(lm[:4], sh[:4], A["candidates"])
        ours = nets.generator(sd["f2f"], c, x)
        theirs = f2f.apply_generator(models.feature2face, x)
    assert float((ours - theirs).abs().max()) < 1e-3
    assert float(ours.std()) > 0.1  # frames with contrast, not a saturated field
