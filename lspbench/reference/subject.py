"""The benchmark's subject: a directory in the reference repo's format,
written from a fixed weight seed, and the reference's own reader of it.

The writer makes every asset and weight itself: a 73-point face, its
tracked jitter and fit translations, the camera, the shoulders, four
candidate images (JPEG, as a released subject keeps them), random weights
of the four networks at the JAX init scales (drawn on the device from one
``torch.Generator``, a few large calls), then three data-dependent steps
so that the random networks behave like trained ones: the APC feature bank
is the APC encoder's own output on speech-like audio, the mouth and head
heads are scaled so the mouth moves a few pixels and the head a few
degrees, and the renderer's BatchNorm statistics are those of its own
activations on the subject's frames.  The YAML names the data root and
each stage's checkpoint, as ``config/<id>.yaml`` does.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from typing import Dict, Tuple

import numpy as np
import torch

from lspbench import speech
from lspbench.reference import motion, nets, render
from lspbench.reference.nets import StateDict

FORMAT = 2  # bump when the writer changes what it writes
NETS = ("apc", "a2f", "a2h", "f2f")
SPECS = {"apc": nets.spec_apc, "a2f": nets.spec_a2f, "a2h": nets.spec_a2h, "f2f": nets.spec_f2f}
CKPT = {"apc": "apc.pkl", "a2f": "audio2feature.pkl", "a2h": "audio2headpose.pkl",
        "f2f": "feature2face.pkl"}
# what the writer aims the random heads at, unless the config says
# (``mouth_std``; ``head_std``: rotations in degrees, translations in units)
MOUTH_STD = 0.004
HEAD_STD = (1.5, 1.5, 1.5, 0.004, 0.004, 0.004)
RES_GAIN = 0.1


def _face(rng: np.random.Generator) -> np.ndarray:
    """A 73-point 3D face about 0.2 units across, mouth on rows 46-63."""
    pts = np.zeros((73, 3))
    ang = np.linspace(-np.pi * 0.8, np.pi * 0.8, 15)
    pts[0:15] = np.stack([0.1 * np.sin(ang), -0.1 * np.cos(ang), np.zeros(15)], 1)
    pts[15:21] = [[0.02 + 0.008 * i, 0.06, 0.01] for i in range(6)]
    pts[21:27] = [[-0.02 - 0.008 * i, 0.06, 0.01] for i in range(6)]
    pts[27:31] = [[0.04 - 0.005 * i, 0.03, 0.012] for i in range(4)]
    pts[31:35] = [[-0.04 + 0.005 * i, 0.03, 0.012] for i in range(4)]
    pts[65:73] = pts[27:35] + [0.0, 0.005, 0.0]
    pts[35:46] = [[0.0, 0.02 - 0.006 * i, 0.02] for i in range(11)]
    mang = np.linspace(0, 2 * np.pi, 18, endpoint=False)
    pts[46:64] = np.stack([0.03 * np.cos(mang), -0.05 + 0.015 * np.sin(mang),
                           np.full(18, 0.015)], 1)
    pts[64] = [0.0, -0.05, 0.015]
    return (pts + rng.normal(0, 1e-3, pts.shape)).astype(np.float32)


def _assets(c: dict, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    size = c["image_size"]
    mean = _face(rng)
    tracked = (mean[None] + rng.normal(0, 2e-3, (40, 73, 3))).astype(np.float32)
    trans = np.array([0.0, 0.05, 1.0]) + rng.normal(0, 1e-3, (40, 3))
    f = 2.4 * size
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    xs = np.linspace(size * 0.2, size * 0.8, 9)
    y0 = size * 0.8
    sh2 = np.concatenate([np.stack([xs, np.full(9, y0)], 1),
                          np.stack([xs, np.full(9, y0 + size / 36)], 1)]).astype(np.float32)
    sh3 = np.concatenate([np.stack([(xs - size / 2) / f, np.full(9, (y0 - size / 2) / f),
                                    np.ones(9)], 1),
                          np.stack([(xs - size / 2) / f,
                                    np.full(9, (y0 + size / 36 - size / 2) / f), np.ones(9)], 1)])
    # smooth colour fields with some texture, as photographs of one subject
    base = rng.uniform(40, 215, (3, 4, 4))
    low = torch.as_tensor(np.stack([base + rng.normal(0, 25, base.shape) for _ in range(4)]))
    img = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear",
                                          align_corners=True).permute(0, 2, 3, 1).numpy()
    cands = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    return {"mean_pts3d": mean, "tracked": tracked, "trans": trans.astype(np.float32)[..., None],
            "K": K, "shoulders2d": sh2, "shoulder3D": np.stack([sh3, sh3]).astype(np.float32),
            "candidates": cands}


def _random_weights(c: dict, gen: torch.Generator, device) -> Dict[str, StateDict]:
    """Linear and conv weights N(0, 0.02) and zero biases, BatchNorm scales
    N(1, 0.02) with statistics (0, 1), recurrent weights U(-1/sqrt(H),
    1/sqrt(H)): one normal and one uniform draw for all of them."""
    specs = {name: SPECS[name](c) for name in NETS}
    normal = [(n, k, s) for n in NETS for k, s, kind in specs[n] if kind in ("w", "bn_w")]
    unif = [(n, k, s) for n in NETS for k, s, kind in specs[n] if kind == "rnn"]
    z = torch.randn(sum(math.prod(s) for _, _, s in normal), generator=gen, device=device)
    u = torch.rand(sum(math.prod(s) for _, _, s in unif), generator=gen, device=device)
    out: Dict[str, StateDict] = {n: {} for n in NETS}
    for pool, group in ((z, normal), (u, unif)):
        at = 0
        for n, k, s in group:
            out[n][k] = pool[at:at + math.prod(s)].view(s).clone()
            at += math.prod(s)
    for n in NETS:
        for k, s, kind in specs[n]:
            t = out[n].get(k)
            if kind == "w":
                out[n][k] = t * 0.02
            elif kind == "bn_w" and k.endswith("block.4.weight"):
                # a residual branch's last scale: small, as in a trained
                # ResNet, so a block starts near the identity
                out[n][k] = RES_GAIN * (1.0 + 0.02 * t)
            elif kind == "bn_w":
                out[n][k] = 1.0 + 0.02 * t
            elif kind == "rnn":
                hidden = c["apc_hidden"] if n == "apc" else c["a2f_lstm_hidden"]
                out[n][k] = (t * 2 - 1) / math.sqrt(hidden)
            elif kind == "bn_var":
                out[n][k] = torch.ones(s, device=device)
            elif kind == "count":
                out[n][k] = torch.zeros((), dtype=torch.int64, device=device)
            else:  # biases and running means
                out[n][k] = torch.zeros(s, device=device)
    return out


class _StatInit(nets.ConvRunner):
    """A forward that sets each BatchNorm's running statistics from its own
    input batch before normalising with them: half the batch mean as the
    mean, and the mean square about it as the variance, floored at a tenth
    of the layer's mean square.  The frames of one subject differ little,
    and a full batch mean and variance would cancel what they share and blow
    up what little differs, rounding included, at the innermost maps (a few
    pixels)."""

    def norm(self, y, conv_key, bn):
        dims = (0, 2, 3)
        mean = 0.5 * y.mean(dim=dims)
        var = ((y - mean.view(1, -1, 1, 1)) ** 2).mean(dim=dims)
        self.sd[f"{bn}.running_mean"] = mean
        self.sd[f"{bn}.running_var"] = torch.maximum(var, 0.1 * (y * y).mean())
        return nets.batchnorm(y, self.sd, bn)


def _scale_heads(c: dict, A: dict, sd: Dict[str, StateDict], audio: np.ndarray) -> None:
    """Scale the mouth head (fc.6) and the head-pose means (end_conv_2's mean
    rows) to the mouth's and the head's spread over the frames of ``audio``,
    and set the head-pose sigmas to a quarter of the head's once the
    sampling scale is applied."""
    dev = A["bank"].device
    mouth_std, head_std = c.get("mouth_std", MOUTH_STD), c.get("head_std", HEAD_STD)
    feats = motion.apc_features(c, sd["apc"], A["bank"], motion.log_mel(audio, dev))
    mouth = motion.audio2feature(c, sd["a2f"], feats)
    k = mouth_std / float(mouth.std(dim=0).mean().clamp(min=1e-12))
    sd["a2f"]["fc.6.weight"] *= k
    sd["a2f"]["fc.6.bias"] *= k
    C, D = c["a2h_ncenter"], c["a2h_ndim"]
    w, b = sd["a2h"]["WaveNet.end_conv_2.weight"], sd["a2h"]["WaveNet.end_conv_2.bias"]
    target = torch.tensor(list(head_std) * (D // len(head_std)), device=dev)
    w[C + C * D:] *= 0.1
    b[C + C * D:] = torch.log(c["a2h_sigma"] / (0.25 * target)).repeat(C)
    head = motion.audio2headpose(c, sd["a2h"], feats, seed=0)
    std = head.std(dim=0).clamp(min=1e-12)
    rows = (target / std).repeat(C)
    w[C:C + C * D] *= rows[:, None, None]
    b[C:C + C * D] *= rows


def digest(c: dict) -> str:
    """What the writer reads of a config (its limits and notes are not)."""
    keep = {k: v for k, v in c.items() if k not in ("limits", "assumed", "source", "control")}
    return hashlib.sha256(json.dumps({"format": FORMAT, "config": keep}, sort_keys=True)
                          .encode()).hexdigest()[:16]


def write_subject(c: dict, root: str, device) -> None:
    """Write the subject of config ``c`` into ``root`` (replaced whole)."""
    from PIL import Image

    tmp = root + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "candidates"))
    seed = int(c["weight_seed"])
    rng = np.random.default_rng(seed)
    a = _assets(c, rng)
    np.save(os.path.join(tmp, "mean_pts3d.npy"), a["mean_pts3d"])
    np.save(os.path.join(tmp, "tracked3D_normalized_pts_fix_contour.npy"), a["tracked"])
    np.savez(os.path.join(tmp, "3d_fit_data.npz"), trans=a["trans"])
    np.save(os.path.join(tmp, "camera_intrinsic.npy"), a["K"])
    np.save(os.path.join(tmp, "normalized_shoulder_points.npy"), a["shoulders2d"])
    np.save(os.path.join(tmp, "shoulder_points3D.npy"), a["shoulder3D"])
    for j, img in enumerate(a["candidates"]):
        Image.fromarray(img).save(os.path.join(tmp, "candidates", f"normalized_full_{j}.jpg"),
                                  quality=95)

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad(), nets.f32_strict():
        sd = _random_weights(c, gen, device)
        # the feature bank: the encoder's own features of speech-like audio
        bank_audio = speech.speech(c["bank_size"] / 120.0 + 0.5, rng)
        feats = motion.gru_stack(sd["apc"], "rnns.", c["apc_layers"],
                                 motion.log_mel(bank_audio, device))[:c["bank_size"]]
        np.save(os.path.join(tmp, "APC_feature_base.npy"), feats.cpu().numpy())
        A = read_assets(tmp, c, device)
        calib = speech.speech(2.0, rng)
        _scale_heads(c, A, sd, calib)
        lm, sh = motion.motion(c, A, sd, calib, seed=0, device=device)
        pick = np.linspace(0, len(lm) - 1, 8).astype(int)
        x = render.render_input(lm[pick], sh[pick], A["candidates"])
        nets.generator(sd["f2f"], c, x, _StatInit(sd["f2f"], c))
    for n in NETS:
        torch.save({k: v.cpu() for k, v in sd[n].items()}, os.path.join(tmp, CKPT[n]))

    rel = os.path.relpath(root)
    yaml_text = "\n".join([
        f"name: {c['name']}",
        "dataset_params:",
        f"  root: {rel}",
        "model_params:",
        "  APC:",
        f"    ckp_path: {os.path.join(rel, CKPT['apc'])}",
        f"    mel_dim: {c['mel_dim']}",
        f"    hidden_size: {c['apc_hidden']}",
        f"    num_layers: {c['apc_layers']}",
        "    residual: false",
        "    use_LLE: true",
        f"    Knear: {c['lle_k']}",
        f"    LLE_percent: {c['lle_percent']}",
        "  Audio2Mouth:",
        f"    ckp_path: {os.path.join(rel, CKPT['a2f'])}",
        f"    smooth: {c['a2f_smooth']}",
        f"    AMP: [{', '.join(str(v) for v in c['a2f_amp'])}]",
        "  Headpose:",
        f"    ckp_path: {os.path.join(rel, CKPT['a2h'])}",
        f"    sigma: {c['a2h_sigma']}",
        f"    smooth: [{c['a2h_smooth'][0]}, {c['a2h_smooth'][1]}]",
        f"    AMP: [{c['a2h_rot_amp']}, {c['a2h_trans_amp']}]",
        f"    shoulder_AMP: {c['shoulder_amp']}",
        "  Image2Image:",
        f"    ckp_path: {os.path.join(rel, CKPT['f2f'])}",
        f"    size: {c['size']}",
        ""])
    with open(os.path.join(tmp, f"{c['name']}.yaml"), "w") as f:
        f.write(yaml_text)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write(digest(c))
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)


def ensure_subject(c: dict, root: str, device) -> bool:
    """Write the subject unless ``root`` holds this config's; True if
    written."""
    try:
        with open(os.path.join(root, "DONE")) as f:
            if f.read() == digest(c):
                return False
    except FileNotFoundError:
        pass
    write_subject(c, root, device)
    return True


def read_assets(root: str, c: dict, device) -> dict:
    """The subject's arrays as the reference uses them (the bank and the
    candidates as float32 tensors on ``device``, the rest as numpy)."""
    from PIL import Image

    mean = np.load(os.path.join(root, "mean_pts3d.npy")).astype(np.float64)
    tracked = np.load(os.path.join(root, "tracked3D_normalized_pts_fix_contour.npy"))
    trans = np.load(os.path.join(root, "3d_fit_data.npz"))["trans"][:, :, 0].astype(np.float64)
    cands = []
    for j in range(4):
        with Image.open(os.path.join(root, "candidates", f"normalized_full_{j}.jpg")) as im:
            cands.append((np.asarray(im).astype(np.float32) / 255.0 - 0.5) / 0.5)
    brows = list(motion.EYE_BROW_INDICES)
    bank = np.load(os.path.join(root, "APC_feature_base.npy")).astype(np.float32)
    return {
        "mean_pts3d": mean,
        "std_mean_pts3d": tracked.astype(np.float64).mean(axis=0),
        "candidate_eye_brow": (tracked.astype(np.float64) - mean)[10:, brows],
        "mean_translation": trans.mean(axis=0),
        "ref_trans": trans[1],
        "camera_intrinsic": np.load(os.path.join(root, "camera_intrinsic.npy")),
        "shoulder3D": np.load(os.path.join(root, "shoulder_points3D.npy"))[1].astype(np.float64),
        "scale": 1.0,
        "bank": torch.as_tensor(bank, device=device),
        "candidates": torch.as_tensor(np.stack(cands), device=device),
    }


def read_weights(root: str, device) -> Dict[str, StateDict]:
    out = {}
    for n in NETS:
        sd = torch.load(os.path.join(root, CKPT[n]), map_location="cpu", weights_only=True)
        out[n] = {k: v.to(device).float() if v.is_floating_point() else v for k, v in sd.items()}
    return out


def read_subject(root: str, c: dict, device) -> Tuple[dict, Dict[str, StateDict]]:
    return read_assets(root, c, device), read_weights(root, device)
