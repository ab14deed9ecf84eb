"""Model zoo of the port: every single-input classifier of the JAX
registry.

Port of ``medical_image_classification_tpu/models/registry.py``: the
Mamba-1 MedMamba configurations, MedSSD, CNN-Mamba (with and without
MIFA), ST-SSD, the in-block KAN models (kaninSSD, kanoutSSD) and MedSSD
with each KAN head; and the dual-input fusion registry: the CrossMamba
classifiers and fusion U-Nets (FusionMamba is not ported yet, ROADMAP.md
Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from medical_image_classification_tpu_torch.models.crossmamba import (
    CrossVSSMClassifier,
    FusionVFEFM,
)
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
            f"unknown model {name!r}; available: {available_models()}")
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


def _ssd16(num_classes, kw, **extra):
    """The SSD family at d_state 16 (N 64 over the four directions):
    depths 2-2-4-2, dims 128..1024, headdim 64."""
    return _build(num_classes, dict(depths=(2, 2, 4, 2),
                  dims=(128, 256, 512, 1024), d_state=16, core="ssd",
                  **extra), kw)


@register("cnn_mamba")
def cnn_mamba(num_classes, **kw):
    """CNN-Mamba: the SSD core at d_state 16 behind the ConvTConvPW RGB
    pre-stem."""
    return _ssd16(num_classes, kw, conv_stem=True)


@register("cnn_mamba_mifa")
def cnn_mamba_mifa(num_classes, **kw):
    """CNN-Mamba with a MIFA block after the patch embed."""
    return _ssd16(num_classes, kw, conv_stem=True, use_mifa=True)


@register("kanin_ssd")
def kanin_ssd(num_classes, **kw):
    """kaninSSD: an efficient-KAN in_proj in every SS2DSSD (order 1)."""
    return _ssd16(num_classes, kw, kan_in=True, kan_spline_order=1)


@register("kanout_ssd")
def kanout_ssd(num_classes, **kw):
    """kanoutSSD: an efficient-KAN filter before every in_proj (order 1)."""
    return _ssd16(num_classes, kw, kan_filter=True, kan_spline_order=1)


@register("medssd_ekan")
def medssd_ekan(num_classes, **kw):
    """MedSSD (d_state 16) with one efficient-KAN head, spline order 3."""
    return _ssd16(num_classes, kw, head="ekan", kan_spline_order=3)


@register("medssd_okan")
def medssd_okan(num_classes, **kw):
    """MedSSD (d_state 16) with one original-KAN head."""
    return _ssd16(num_classes, kw, head="okan")


@register("medssd_kan")
def medssd_kan(num_classes, **kw):
    """MedSSD (d_state 16) with three chained original-KAN layers."""
    return _ssd16(num_classes, kw, head="kan_stack")


@register("medssd_kanmodule")
def medssd_kanmodule(num_classes, **kw):
    """MedSSD (d_state 16) with the KansModule head."""
    return _ssd16(num_classes, kw, head="kan_module")


@register("medssd_3kan")
def medssd_3kan(num_classes, **kw):
    """MedSSD (d_state 16) with the ThreeKansModule head."""
    return _ssd16(num_classes, kw, head="3kan")


# --- dual-input fusion / cross models (two inputs: a registry of their own)

_FUSION_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_fusion(name):
    def deco(fn):
        _FUSION_REGISTRY[name] = fn
        return fn
    return deco


def available_fusion_models():
    return sorted(_FUSION_REGISTRY)


def create_fusion_model(name: str, **kw):
    if name == "fusionmamba":
        raise NotImplementedError(
            "fusionmamba (models/fusionmamba.py) is not ported yet "
            "(ROADMAP.md Queue 1 item 6)")
    if name not in _FUSION_REGISTRY:
        raise KeyError(f"unknown fusion model {name!r}; available: "
                       f"{available_fusion_models()}")
    return _FUSION_REGISTRY[name](**kw)


@register_fusion("vfefm_2b2")
def vfefm_2b2(**kw):
    """CrossMamba fusion U-Net, dual decoder."""
    return FusionVFEFM(**kw)


@register_fusion("vfefm_2c1")
def vfefm_2c1(**kw):
    """The single-decoder variant."""
    return FusionVFEFM(single_decoder=True, **kw)


def _cross_cls(num_classes, fuse_mode, kw):
    kw.setdefault("d_state", 128)        # the reference classifiers'
    return CrossVSSMClassifier(num_classes=num_classes, fuse_mode=fuse_mode,
                               **kw)


@register_fusion("cross_cls_stage3")
def cross_cls_stage3(num_classes=8, **kw):
    """Dual-branch classifier, fusion after stage 3, branches summed."""
    return _cross_cls(num_classes, "stage3", kw)


@register_fusion("cross_cls_4ef")
def cross_cls_4ef(num_classes=8, **kw):
    """Dual-branch classifier, fusion at every stage."""
    return _cross_cls(num_classes, "all", kw)


@register_fusion("cross_cls_3e1fadd1e")
def cross_cls_3e1fadd1e(num_classes=8, **kw):
    """Fused branches summed, then one shared downsample and stage 4."""
    return _cross_cls(num_classes, "stage3_merged", kw)
