"""Model zoo of the port: the registry names ported so far.

Port of ``medical_image_classification_tpu/models/registry.py`` for the
Mamba-1 MedMamba configurations, MedSSD and ST-SSD.  The other names of
the JAX registry come with later slices (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from medical_image_classification_tpu_torch.models.vssm import VSSM

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_models():
    return sorted(_REGISTRY)


def create_model(name: str, num_classes: int, **kw):
    if name not in _REGISTRY:
        raise KeyError(
            f"model {name!r} is not ported to the torch package yet; ported: "
            f"{available_models()} (the rest: ROADMAP.md Queue 1)")
    return _REGISTRY[name](num_classes=num_classes, **kw)


def _build(num_classes, defaults, overrides):
    cfg = dict(defaults)
    cfg.update(overrides)
    return VSSM(num_classes=num_classes, **cfg)


@register("medmamba")
def medmamba(num_classes, **kw):
    """MedMamba (Mamba-1 core): depths 2-2-4-2, dims 96..768, d_state 16."""
    return _build(num_classes, dict(depths=(2, 2, 4, 2),
                  dims=(96, 192, 384, 768), d_state=16), kw)


@register("medmamba_t")
def medmamba_t(num_classes, **kw):
    return medmamba(num_classes, **kw)


@register("medmamba_s")
def medmamba_s(num_classes, **kw):
    """MedMamba-S: deeper stage 3."""
    return _build(num_classes, dict(depths=(2, 2, 8, 2),
                  dims=(96, 192, 384, 768), d_state=16), kw)


@register("medmamba_b")
def medmamba_b(num_classes, **kw):
    return _build(num_classes, dict(depths=(2, 2, 12, 2),
                  dims=(128, 256, 512, 1024), d_state=16), kw)


@register("medssd")
def medssd(num_classes, **kw):
    """MedSSD (Mamba-2 / SSD core): depths 2-2-4-2, dims 128..1024,
    d_state 128 (with the directions coupled through the state, N = 512),
    headdim 64."""
    return _build(num_classes, dict(depths=(2, 2, 4, 2),
                  dims=(128, 256, 512, 1024), d_state=128, core="ssd"), kw)


@register("st_ssd")
def st_ssd(num_classes, **kw):
    """ST-SSD: the SSD core (d_state 16, coupled over the four directions
    to N 64) with the semantic-token STL / STF / WMF tail; p = 56, 28, 14,
    7 tokens per side at 224x224."""
    return _build(num_classes, dict(depths=(2, 2, 4, 2),
                  dims=(128, 256, 512, 1024), d_state=16, core="ssd",
                  st_tokens=(56, 28, 14, 7)), kw)
