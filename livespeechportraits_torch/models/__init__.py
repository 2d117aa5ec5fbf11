"""The model registry (JAX ``models/__init__.py:24-55``, replacing the
reference's importlib factories): each family's module class, built from its
config, and its apply function.  Beside JAX's entries the registry names the
Audio2Feature WaveNet decoder, which JAX defines but does not register.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

from livespeechportraits_torch.models import (apc, audio2feature, audio2headpose,  # noqa: F401
                                              feature2face, losses, nn_core, wavenet)


class ModelDef(NamedTuple):
    build: Callable[..., Any]  # config -> nn.Module
    apply: Callable[..., Any]


REGISTRY: Dict[str, ModelDef] = {
    "apc": ModelDef(apc.APCEncoder, apc.apply_apc),
    "audio2feature": ModelDef(audio2feature.Audio2Feature, audio2feature.apply_audio2feature),
    "audio2feature_wavenet": ModelDef(audio2feature.Audio2FeatureWaveNet,
                                      audio2feature.apply_audio2feature_wavenet),
    "audio2headpose": ModelDef(audio2headpose.Audio2Headpose,
                               audio2headpose.apply_audio2headpose),
    "audio2headpose_lstm": ModelDef(audio2headpose.Audio2HeadposeLSTM,
                                    audio2headpose.apply_audio2headpose_lstm),
    "feature2face": ModelDef(feature2face.Feature2FaceG, feature2face.apply_generator),
    "feature2face_d": ModelDef(feature2face.Feature2FaceD, feature2face.apply_discriminator),
}


def create_model(name: str) -> ModelDef:
    """A model family by name, case-insensitive (the reference's create_model)."""
    try:
        return REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}") from None
