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
kernels at N 64 (``JAX_PATHS`` holds the JAX side)."""

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
