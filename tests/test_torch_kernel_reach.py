"""Which SSD kernel each stage of ``medssd``, ``st_ssd`` and ``cnn_mamba``
(and so the other SSD models at d_state 16: cnn_mamba_mifa, kanin_ssd,
kanout_ssd and the medssd KAN heads, whose cores are cnn_mamba's) reaches at
224, 240, 256 and 512 pixels a side: the port's dispatch (its
``ss2d_core_ssd`` run on meta tensors at the stage's full shape, batch 32,
bf16, with the card's gates; the kernels' entry points replaced by stubs
that record the call) against the JAX package's gates in the order of its
``ss2d_core_ssd`` and ``ssd_chunked`` (the four-direction fused SSD, then
the single-layout fused SSD, then Y_diag, else the einsums), with the three
JAX kernel modules in interpret mode standing in for the TPU backend.  The
table pins the paths: ``medssd`` at 240x240 takes the single-layout fused
SSD at stage 1 (L 900 padded to 4 chunks of 256) and Y_diag at N 512 at
stage 2.

``cnn_mamba`` (N 64, merged) is where the port departs from the JAX gates:
the JAX dirs gate needs N % 128 == 0 (a TPU lane term,
``kernels/ssd_fused_dirs_pallas.py:154``), so the JAX package takes Y_diag
or the einsums at its stage 0; the port's card gate has no lane term (P
and N multiples of 32, N <= 512), so its stages 0-1 at 224 take the dirs
kernels at N 64 (``JAX_PATHS`` holds the JAX side).

The CrossMamba family (N 512, merged) has an SSD call at each block and at
each CrossMamba fusion, whose d_ssm is twice the stage's dim: ``SITES``
pins each call site of ``cross_cls_stage3`` and ``cross_cls_4ef`` at
224x224 and of ``vfefm_2b2`` at 256x256 (its decoder stages at the
encoder's sides), where the port and the JAX gates agree: the dirs
kernels at the 56/28 (64/32) sides, Y_diag at N 512 at vfefm's 16x16
(H 32 and 64), the einsums below.  ``cross_cls_3e1fadd1e`` has
cross_cls_stage3's sites, ``vfefm_2c1`` a subset of vfefm_2b2's."""

import pytest
import torch

import medical_image_classification_tpu.kernels.ssd as jssd
import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
import medical_image_classification_tpu.kernels.ssd_fused_pallas as jsf
import medical_image_classification_tpu.kernels.ssd_ydiag_pallas as jyd
import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.ops.ss2d as tss2d

torch.set_num_threads(1)

# the registry's SSD models: (d_state, merge); both have depths 2-2-4-2,
# d_ssm 128, 256, 512, 1024 over the stages, headdim 64, chunk 256
MODELS = {"medssd": (128, True), "st_ssd": (16, False),
          "cnn_mamba": (16, True)}
D_SSM, HEADDIM, CHUNK, BATCH, K = (128, 256, 512, 1024), 64, 256, 32, 4

# (path, chunk l, chunks nc) per stage
EXPECTED = {
    ("medssd", 224): [("dirs", 224, 14), ("dirs", 196, 4),
                      ("einsum", 200, 1), ("einsum", 56, 1)],
    ("medssd", 240): [("dirs", 240, 15), ("fused", 256, 4),
                      ("ydiag", 232, 1), ("einsum", 56, 1)],
    ("medssd", 256): [("dirs", 256, 16), ("dirs", 256, 4),
                      ("ydiag", 256, 1), ("einsum", 64, 1)],
    ("medssd", 512): [("dirs", 256, 64), ("dirs", 256, 16),
                      ("dirs", 256, 4), ("ydiag", 256, 1)],
    ("st_ssd", 224): [("ydiag", 224, 14), ("einsum", 196, 4),
                      ("einsum", 200, 1), ("einsum", 56, 1)],
    ("st_ssd", 240): [("ydiag", 240, 15), ("einsum", 225, 4),
                      ("ydiag", 232, 1), ("einsum", 56, 1)],
    ("st_ssd", 256): [("ydiag", 256, 16), ("ydiag", 256, 4),
                      ("ydiag", 256, 1), ("einsum", 64, 1)],
    ("st_ssd", 512): [("ydiag", 256, 64), ("ydiag", 256, 16),
                      ("ydiag", 256, 4), ("ydiag", 256, 1)],
    ("cnn_mamba", 224): [("dirs", 224, 14), ("dirs", 196, 4),
                         ("einsum", 200, 1), ("einsum", 56, 1)],
    ("cnn_mamba", 240): [("dirs", 240, 15), ("einsum", 225, 4),
                         ("ydiag", 232, 1), ("einsum", 56, 1)],
}
# the JAX package's paths where they are not the port's
JAX_PATHS = {
    ("cnn_mamba", 224): [("ydiag", 224, 14), ("einsum", 196, 4),
                         ("einsum", 200, 1), ("einsum", 56, 1)],
    ("cnn_mamba", 240): [("ydiag", 240, 15), ("einsum", 225, 4),
                         ("ydiag", 232, 1), ("einsum", 56, 1)],
}


def _sides(size):
    """Tokens per side at each stage: the patch embed divides by 4, each
    patch merge halves (an odd side is cropped first)."""
    s = [size // 4]
    for _ in range(3):
        s.append(s[-1] // 2)
    return s


def _jax_path(L, N, H, d_ssm, merge):
    """The JAX package's dispatch from its gates (bf16: itemsize 2)."""
    if merge:
        c = jssd.ssd_dirs_chunk(L, CHUNK, N, HEADDIM, H, 2, d_ssm)
        if c is not None:
            return ("dirs", c, L // c)
    c = jssd._effective_chunk(L, CHUNK, N, HEADDIM, 1, H, 2, True)
    nc = -(-L // c)
    if jsf.ssd_fused_supported(c, N, HEADDIM, 1, nc, H, 2):
        return ("fused", c, nc)
    if jyd.ydiag_supported(c, N, HEADDIM, 1, H, 2):
        return ("ydiag", c, nc)
    return ("einsum", c, nc)


def _port_path(monkeypatch, side, d_state, d_ssm, merge):
    """The port's dispatch: ``ss2d_core_ssd`` on meta tensors with the
    card's gates, the kernels' entry points recording their chunk shapes."""
    calls = []

    def card(gate):
        return lambda *a, **k: gate(*a, **{**k, "card": True})

    def dirs(stackc, acum, *a, **k):
        calls.append(("dirs", stackc.shape[2], stackc.shape[1]))
        B, nc, l, _ = stackc.shape
        return stackc.new_empty(B, nc, l, acum.shape[2] * HEADDIM)

    def fused(Cc, Bc, acum, dte, cdec, dtp, x, impl):
        calls.append(("fused", Cc.shape[2], Cc.shape[1]))
        return torch.empty_like(x)

    def ydiag(Cc, Bc, acum, dtx, impl):
        calls.append(("ydiag", Cc.shape[1], None))
        return torch.empty_like(dtx)

    monkeypatch.setattr(tss2d, "ssd_dirs_chunk", card(tssd.ssd_dirs_chunk))
    monkeypatch.setattr(tssd, "ssd_fused_supported",
                        card(tssd.ssd_fused_supported))
    monkeypatch.setattr(tssd, "ydiag_supported", card(tssd.ydiag_supported))
    monkeypatch.setattr(tssd, "ssd_fused_dirs", dirs)
    monkeypatch.setattr(tssd, "ssd_fused", fused)
    monkeypatch.setattr(tssd, "ydiag_fused", ydiag)
    nheads = d_ssm // HEADDIM
    meta = dict(device="meta", dtype=torch.bfloat16)
    xBCdt = torch.empty(BATCH, side, side, d_ssm + 2 * d_state + nheads,
                        **meta)
    rows = lambda: torch.empty(K, nheads, device="meta")
    y = tss2d.ss2d_core_ssd(xBCdt, rows(), rows(), rows(), d_ssm=d_ssm,
                            d_state=d_state, nheads=nheads, headdim=HEADDIM,
                            chunk_size=CHUNK, merge=merge,
                            stack_scan_order=not merge)
    assert y.dtype == torch.bfloat16
    L = side * side
    if not calls:
        c = tssd._pick_chunk(L, CHUNK, K * d_state)
        return ("einsum", c, -(-L // c))
    (path, l, nc), = calls
    return (path, l, -(-L // l) if nc is None else nc)


@pytest.mark.parametrize("model,size", list(EXPECTED),
                         ids=[f"{m}-{s}" for m, s in EXPECTED])
def test_port_reaches_the_kernels_the_jax_gates_pick(monkeypatch, model,
                                                     size):
    for mod in (jsfd, jsf, jyd):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    d_state, merge = MODELS[model]
    N = K * d_state
    got, want = [], []
    for side, d_ssm in zip(_sides(size), D_SSM):
        H = K * d_ssm // HEADDIM
        want.append(_jax_path(side * side, N, H, d_ssm, merge))
        with monkeypatch.context() as mp:
            got.append(_port_path(mp, side, d_state, d_ssm, merge))
    assert got == EXPECTED[model, size]
    assert want == JAX_PATHS.get((model, size), EXPECTED[model, size])


# (side, d_ssm) of each SSD call site of the CrossMamba family (headdim 64,
# d_state 128: N 512) -> (path, chunk l, chunks nc); blocks at d_ssm = dim,
# fusions at 2 dim
_CROSS_224 = {"blocks 0": ((56, 128), ("dirs", 224, 14)),
              "blocks 1": ((28, 256), ("dirs", 196, 4)),
              "blocks 2": ((14, 512), ("einsum", 200, 1)),
              "fusion 2": ((14, 1024), ("einsum", 200, 1)),
              "blocks 3": ((7, 1024), ("einsum", 56, 1))}
SITES = {
    ("cross_cls_stage3", 224): _CROSS_224,
    ("cross_cls_4ef", 224): {
        **_CROSS_224,
        "fusion 0": ((56, 256), ("dirs", 224, 14)),
        "fusion 1": ((28, 512), ("dirs", 196, 4)),
        "fusion 3": ((7, 2048), ("einsum", 56, 1))},
    # encoder stage i and decoder stages at the same side share shapes
    ("vfefm_2b2", 256): {
        "blocks 0, up 2-3": ((64, 128), ("dirs", 256, 16)),
        "fusion 0, up 2-3": ((64, 256), ("dirs", 256, 16)),
        "blocks 1, up 1": ((32, 256), ("dirs", 256, 4)),
        "fusion 1, up 1": ((32, 512), ("dirs", 256, 4)),
        "blocks 2, up 0": ((16, 512), ("ydiag", 256, 1)),
        "fusion 2, up 0": ((16, 1024), ("ydiag", 256, 1)),
        "blocks 3": ((8, 1024), ("einsum", 64, 1)),
        "fusion 3": ((8, 2048), ("einsum", 64, 1))},
}


@pytest.mark.parametrize("model,size", list(SITES),
                         ids=[f"{m}-{s}" for m, s in SITES])
def test_crossmamba_family_reaches_the_kernels_the_jax_gates_pick(
        monkeypatch, model, size):
    for mod in (jsfd, jsf, jyd):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    N = K * 128
    for site, ((side, d_ssm), want) in SITES[model, size].items():
        H = K * d_ssm // HEADDIM
        assert _jax_path(side * side, N, H, d_ssm, True) == want, site
        with monkeypatch.context() as mp:
            assert _port_path(mp, side, 128, d_ssm, True) == want, site


@pytest.mark.parametrize("name", ["cross_cls_stage3", "cross_cls_4ef",
                                  "cross_cls_3e1fadd1e", "vfefm_2b2",
                                  "vfefm_2c1"])
def test_chip_smoke_launches_per_forward_of_the_crossmamba_family(
        monkeypatch, name):
    """chip_smoke.py's CROSS_PATHS (the launches it pins per forward) equal
    the SSD kernels the port's full-width model reaches: its forward on
    meta tensors (224x224 or 256x256, bf16, batch 2) with the card's
    gates, each kernel entry point replaced by a stub that counts."""
    import chip_smoke
    from medical_image_classification_tpu_torch.models import (
        create_fusion_model)
    calls = []

    def card(gate):
        return lambda *a, **k: gate(*a, **{**k, "card": True})

    def dirs(stackc, acum, *a, **k):
        calls.append("ssd_fused_dirs_fwd")
        B, nc, l, _ = stackc.shape
        return stackc.new_empty(B, nc, l, acum.shape[2] * HEADDIM)

    def ydiag(Cc, Bc, acum, dtx, impl):
        calls.append("ssd_ydiag_fwd")
        return torch.empty_like(dtx)

    def fused(Cc, Bc, acum, dte, cdec, dtp, x, impl):
        calls.append("ssd_fused_fwd")
        return torch.empty_like(x)

    monkeypatch.setattr(tss2d, "ssd_dirs_chunk", card(tssd.ssd_dirs_chunk))
    monkeypatch.setattr(tssd, "ssd_fused_supported",
                        card(tssd.ssd_fused_supported))
    monkeypatch.setattr(tssd, "ydiag_supported", card(tssd.ydiag_supported))
    monkeypatch.setattr(tssd, "ssd_fused_dirs", dirs)
    monkeypatch.setattr(tssd, "ssd_fused", fused)
    monkeypatch.setattr(tssd, "ydiag_fused", ydiag)
    unet = name.startswith("vfefm")
    with torch.device("meta"):
        model = create_fusion_model(
            name, dtype=torch.bfloat16,
            **({} if unet else dict(num_classes=8))).eval()
        side = chip_smoke.FUSION_SIZE if unet else chip_smoke.SIZE
        x = torch.empty(2, side, side, 3)
        with torch.no_grad():
            model(x, x)
    assert {k: calls.count(k) for k in set(calls)} == \
        chip_smoke.CROSS_PATHS[name]
