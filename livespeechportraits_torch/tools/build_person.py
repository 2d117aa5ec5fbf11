"""Build a servable subject pack from reference-format training clips.

    python -m livespeechportraits_torch.tools.build_person --dataroot data/NewPerson \\
        --clip_names clip1,clip2 --apc_ckpt checkpoints/apc.pkl [--device cpu]

Writes mean_pts3d.npy, 3d_fit_data.npz, the tracked 3D points,
APC_feature_base.npy, camera_intrinsic.npy, the shoulder files, candidates/
and <name>.yaml into --dataroot (pipeline/build_person.py), after which

    python -m livespeechportraits_torch.demo --id NewPerson --config_dir <dataroot>

serves the subject.  --synth N writes N seconds of synthetic raw clips first
(pipeline/synth_subject.py), so the whole onboarding runs with no data.  The
APC encoder of the feature bank is a reference-format .pkl / .model
checkpoint, or random-init (seed 0) with --apc_random; it must be the encoder
the subject is served with.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataroot", required=True,
                   help="person root holding the clip directories; the pack is written here")
    p.add_argument("--clip_names", required=True, help="comma-separated clip directory names")
    p.add_argument("--apc_ckpt", default="",
                   help="APC encoder of the LLE feature bank (a reference-format torch "
                        "checkpoint); empty skips the bank (use_LLE false)")
    p.add_argument("--apc_random", action="store_true",
                   help="build the bank with the random-init (seed 0) encoder that a pack "
                        "without checkpoints is served with")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--bank_stride", type=int, default=1,
                   help="keep every Nth row of the APC feature bank")
    p.add_argument("--synth", type=float, default=0.0,
                   help="first write each clip as N seconds of a synthetic subject "
                        "(pipeline/synth_subject.py); the first clip has a face")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = p.parse_args(argv)

    import torch

    from livespeechportraits_torch.config import APCConfig
    from livespeechportraits_torch.models.apc import APCEncoder
    from livespeechportraits_torch.pipeline import build_person, synth_subject
    from livespeechportraits_torch.utils.convert import load_state_dict

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda was asked for but torch sees no CUDA device")
    clips = args.clip_names.split(",")
    if args.synth > 0:
        for i, name in enumerate(clips):
            synth_subject.write_raw_clip(args.dataroot, name, int(args.synth * 60), seed=i,
                                         image_size=args.image_size, with_face=i == 0,
                                         device=device)
    apc = None
    if args.apc_ckpt or args.apc_random:
        apc = APCEncoder(APCConfig()).eval().requires_grad_(False)
        if args.apc_ckpt:
            apc.load_state_dict(load_state_dict(args.apc_ckpt), strict=True)
        else:
            apc.reset_parameters(torch.Generator().manual_seed(0))
        apc.to(device)

    manifest = build_person.build_person_pack(args.dataroot, clips, apc=apc,
                                              image_size=args.image_size,
                                              bank_stride=args.bank_stride)
    for k, v in manifest.items():
        print(f"  {k:45s} {v}")
    name = os.path.basename(os.path.normpath(args.dataroot))
    print(f"pack written to {args.dataroot}")
    print(f"next: python -m livespeechportraits_torch.demo --id {name} --config_dir "
          f"{args.dataroot} --driving_audio <wav>")


if __name__ == "__main__":
    main()
