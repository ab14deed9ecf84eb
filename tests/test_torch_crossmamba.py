"""The CrossMamba core, the cross-input merge, the decoder's patch expands
and the fusion registry of the port, against the JAX package.

The core at d_model 16 (d_ssm 32, headdim 8, d_state 8: N 32), batch 2,
8x8 tokens, fp32, the port's seeded weights drawn away from init and
carried into the JAX module, inputs from a numpy seed: both outputs, and
the gradient of every parameter and of the four inputs, within 2e-3 x
max|ref| (outputs, rtol 0) and leaf rel-norm 2e-2 with cosine 0.998
(gradients), through the port's einsum path and through its dirs twin
(the window widened to l >= 8 on the port's side; the JAX dirs gate
refuses N 32, so the JAX side takes its einsums either way).  Also: B, C
and dt come from the cross input, x and z from the own input."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.kernels.ssd_fused_dirs as tsfd
from medical_image_classification_tpu.models import crossmamba as jcm
from medical_image_classification_tpu.models.common import (
    FinalPatchExpand as JFinalPatchExpand,
    PatchExpand as JPatchExpand,
)
from medical_image_classification_tpu.utils.torch_import import _crossmamba
from medical_image_classification_tpu_torch.models import (
    available_fusion_models,
    create_fusion_model,
)
from medical_image_classification_tpu_torch.models.common import (
    FinalPatchExpand,
    PatchExpand,
)
from medical_image_classification_tpu_torch.models.crossmamba import (
    CrossMamba,
    CrossVSSMClassifier,
    FusionVFEFM,
    cat_inputs,
)
from medical_image_classification_tpu_torch.models.vssm import (
    reset_parameters,
)

torch.set_num_threads(2)

D_MODEL, D_STATE, HEADDIM, BATCH, SIDE = 16, 8, 8, 2, 8
# the parameters drawn away from init (norm scales and biases, the SSD
# parameters: at init D = 1 and dt is small)
PERTURB = ("bias", "A_logs", "dt_bias", "Ds", "norm.weight")


def perturb_(model, seed):
    """Seeded init, then the PERTURB leaves moved by N(0, 0.2)."""
    gen = torch.Generator().manual_seed(seed)
    reset_parameters(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(PERTURB):
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model


def grads_close(got, want, rtol=2e-2, min_cos=0.998, abs_floor=2e-4):
    """Leaf-wise rel-norm and cosine: a leaf passes if its error norm is
    under ``abs_floor`` or its rel-norm error is <= rtol with cosine >
    min_cos (``tests/test_torch_ssd16_models.py::_grads_close``)."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = np.asarray(got[k], np.float64).ravel()
        w = np.asarray(w, np.float64).ravel()
        diff = np.linalg.norm(g - w)
        if diff <= abs_floor:
            continue
        nw = np.linalg.norm(w)
        cos = float(g @ w / (np.linalg.norm(g) * nw + 1e-30))
        assert diff / nw <= rtol and cos > min_cos, (k, diff / nw, cos)


def flat_shapes(tree, prefix=""):
    """{path: shape} of a nested dict of arrays (JAX trees, shape structs)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def assert_scaled(got, want, rel=2e-3):
    """Within rel x max|want| (rtol 0), as tests/test_torch_medssd.py."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BATCH, SIDE, SIDE, D_MODEL),
                                dtype=np.float32) for _ in range(5)]


@functools.lru_cache(maxsize=None)
def _core():
    port = perturb_(CrossMamba(D_MODEL, D_STATE, HEADDIM), 1)
    sd = {"c." + k: v.numpy() for k, v in port.state_dict().items()}
    params = _crossmamba(sd, "c", 2 * D_MODEL // HEADDIM)
    return port, params


@functools.lru_cache(maxsize=None)
def _jax_results():
    """The JAX core's two outputs and the gradient of <out1, w> + <out2,
    w> (w the fifth input) over its parameters and its four inputs."""
    _, params = _core()
    u1, u2, c1, c2, w = _inputs(0)
    m = jcm.CrossMamba(d_model=D_MODEL, d_state=D_STATE, headdim=HEADDIM)

    def run(params, ins):
        def loss(p, ins):
            o1, o2 = m.apply({"params": p}, *ins)
            return jnp.sum(o1 * w) + jnp.sum(o2 * w)
        outs = m.apply({"params": params}, *ins)
        return outs, jax.grad(loss, argnums=(0, 1))(params, ins)

    outs, (g_p, g_in) = jax.jit(run)(params, (u1, u2, c1, c2))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(outs), to_np(g_p), to_np(g_in)


def _port_grads(port):
    u1, u2, c1, c2, w = (torch.from_numpy(a) for a in _inputs(0))
    ins = [t.clone().requires_grad_(True) for t in (u1, u2, c1, c2)]
    port.zero_grad(set_to_none=True)
    o1, o2 = port(*ins)
    ((o1 * w).sum() + (o2 * w).sum()).backward()
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    return (o1.detach().numpy(), o2.detach().numpy()), grads, \
        [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("path", ["einsum", "dirs"])
def test_crossmamba_matches_jax(monkeypatch, path):
    """Both outputs and every gradient against the JAX core, fp32."""
    calls = []
    if path == "dirs":
        monkeypatch.setattr(tssd, "_MIN_L", 8)
        fwd = tsfd.ssd_fused_dirs_fwd_ref
        monkeypatch.setattr(tsfd, "ssd_fused_dirs_fwd_ref",
                            lambda *a, **k: calls.append(1) or fwd(*a, **k))
    port, params = _core()
    outs_j, g_pj, g_inj = _jax_results()
    outs, grads, g_in = _port_grads(port)
    assert len(calls) == (2 if path == "dirs" else 0)   # one per branch
    for got, want in zip(outs, outs_j):
        assert_scaled(got, want)
    want = {"c." + k: v.numpy() for k, v in _carried(g_pj).items()}
    grads_close({"c." + k: v for k, v in grads.items()}, want)
    grads_close(dict(enumerate(g_in)), dict(enumerate(g_inj)))


def _carried(jax_params):
    """A JAX CrossMamba tree (params or gradients) under the port's names."""
    from medical_image_classification_tpu_torch.utils.weights import (
        _crossmamba as carry, _writer)
    sd = {}
    carry(_writer(sd), "x", jax_params)
    return {k[2:]: v for k, v in sd.items()}


def test_crossmamba_carrier_round_trip():
    """Port state_dict -> the JAX importer's ``_crossmamba`` -> the carrier
    gives back every tensor bit for bit, and loads strictly."""
    port, params = _core()
    back = _carried(params)
    sd = port.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    CrossMamba(D_MODEL, D_STATE, HEADDIM).load_state_dict(back, strict=True)


def test_cross_input_conditions_the_branch():
    """out1 depends on u1 and c1 only: changing c1 changes it, changing c2
    or u2 does not; the branches share weights but differ."""
    port, _ = _core()
    u1, u2, c1, c2, _ = (torch.from_numpy(a) for a in _inputs(3))
    with torch.no_grad():
        o1, o2 = port(u1, u2, c1, c2)
        o1b, o2b = port(u1, u2, 2.0 * c1, c2)
        o1c, o2c = port(u1, 3.0 * u2, c1, -c2)
    assert not torch.allclose(o1, o1b)
    assert torch.equal(o2, o2b)
    assert torch.equal(o1, o1c)
    assert not torch.allclose(o2, o2c)
    assert not torch.allclose(o1, o2)


def test_crossmamba_refuses_dropout_and_acts_the_same_in_train():
    """The JAX module's dropout (0 in every caller) is not ported: the
    keyword is refused, and the core gives the same outputs in train and
    eval mode (it holds no BatchNorm and no dropout)."""
    with pytest.raises(TypeError, match="unexpected keyword"):
        CrossMamba(D_MODEL, D_STATE, HEADDIM, dropout=0.1)
    port, _ = _core()
    ins = [torch.from_numpy(a) for a in _inputs(4)[:4]]
    with torch.no_grad():
        train = port.train()(*ins)
        evals = port.eval()(*ins)
    for a, b in zip(train, evals):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["none", "add", "stack"])
def test_cat_inputs_match_jax(method):
    rng = np.random.default_rng(4)
    x1, x2 = (rng.standard_normal((2, 4, 4, 8), dtype=np.float32)
              for _ in range(2))
    proj = torch.nn.Linear(16, 8)
    torch.nn.init.normal_(proj.bias)
    jproj = lambda x: x @ proj.weight.detach().numpy().T + \
        proj.bias.detach().numpy()
    want = jcm._cat_inputs(jnp.asarray(x1), jnp.asarray(x2), method, jproj)
    with torch.no_grad():
        got = cat_inputs(torch.from_numpy(x1), torch.from_numpy(x2), method,
                         proj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("final", [False, True], ids=["x2", "x4"])
def test_patch_expands_match_jax(final):
    """PatchExpand (x2) and FinalPatchExpand (x4): the expand, the pixel
    shuffle's channel order and the LayerNorm (eps 1e-6, fp32 out, also
    at bf16 compute)."""
    rng = np.random.default_rng(5)
    c = 32
    x = rng.standard_normal((2, 4, 4, c), dtype=np.float32)
    port = (FinalPatchExpand(c) if final else PatchExpand(c))
    with torch.no_grad():
        port.expand.weight.normal_()
        port.norm.weight.normal_()
        port.norm.bias.normal_()
    params = {"expand": {"kernel": port.expand.weight.detach().numpy().T},
              "norm": {"scale": port.norm.weight.detach().numpy(),
                       "bias": port.norm.bias.detach().numpy()}}
    jmod = JFinalPatchExpand() if final else JPatchExpand()
    want = np.asarray(jmod.apply({"params": params}, x))
    s = 4 if final else 2
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, 4 * s, 4 * s, c // s)
        assert_scaled(got.numpy(), want, 1e-5)
        port.dtype = torch.bfloat16
        assert port(torch.from_numpy(x)).dtype == torch.float32


def test_fusion_registry_names_and_defaults():
    """The six names of the JAX fusion registry with its defaults: the
    classifiers at d_state 128 over the class default of 16, the fusions
    at 128, headdim 64, chunk 256, "stack", full widths; the U-Nets at
    d_state 128, the decoder 2-9-2-2; fusionmamba's EfficientScan U-Net
    at patch 4, depths 2-2-9-2, decoder 2-9-2-2, dims 96..768 (decoder
    reversed), d_state 16 in every scan layer (the JAX model passes it
    through), dt_rank ceil(dim / 16), one-channel inputs, a cross block per
    stage, drop path up to 0.1 (the decoder's schedule reversed)."""
    from medical_image_classification_tpu.models.registry import (
        available_fusion_models as jax_available_fusion_models)
    from medical_image_classification_tpu_torch.models import fusionmamba
    assert available_fusion_models() == jax_available_fusion_models() == [
        "cross_cls_3e1fadd1e", "cross_cls_4ef", "cross_cls_stage3",
        "fusionmamba", "vfefm_2b2", "vfefm_2c1"]
    one_stage = dict(depths=(1,), dims=(128,))
    for name, mode in (("cross_cls_stage3", "stage3"),
                       ("cross_cls_4ef", "all"),
                       ("cross_cls_3e1fadd1e", "stage3_merged")):
        with torch.device("meta"):
            m = create_fusion_model(name, depths=(1, 1), dims=(128, 256))
            m16 = CrossVSSMClassifier(8, **one_stage, fuse_mode="all")
        assert isinstance(m, CrossVSSMClassifier) and m.fuse_mode == mode
        assert m.head.out_features == 8 and m.cat_method == "stack"
        blk = next(mod for mod in m.modules()
                   if type(mod).__name__ == "SS2DSSD")
        assert (blk.d_state, blk.headdim, blk.chunk_size) == (128, 64, 256)
        fusion = next(mod for mod in m.modules()
                      if isinstance(mod, CrossMamba))
        assert (fusion.d_state, fusion.headdim) == (128, 64)
        assert next(mod for mod in m16.modules() if type(
            mod).__name__ == "SS2DSSD").d_state == 16
    for name, single in (("vfefm_2b2", False), ("vfefm_2c1", True)):
        with torch.device("meta"):
            m = create_fusion_model(name)
        assert isinstance(m, FusionVFEFM) and m.single_decoder == single
        assert [len(layer.blocks1 if not single else layer.blocks)
                for layer in m.layers_up] == [2, 9, 2, 2]
        assert [len(layer.blocks1) for layer in m.layers] == [2, 2, 4, 2]
        assert m.layers[0].fusion.d_ssm == 256
    with torch.device("meta"):
        m = create_fusion_model("fusionmamba")
    assert isinstance(m, fusionmamba.VSSMFusion)
    assert m.patch_embed1.proj.in_channels == 1
    assert m.patch_embed1.proj.kernel_size == (4, 4)
    assert [len(s.blocks) for s in m.layers] == [2, 2, 9, 2]
    assert [len(s.blocks) for s in m.layers_up] == [2, 9, 2, 2]
    assert [s.blocks[0].norm.normalized_shape[0] for s in m.layers] == \
        [96, 192, 384, 768]
    assert [s.blocks[0].norm.normalized_shape[0] for s in m.layers_up] == \
        [768, 384, 192, 96]
    assert len(m.Cross_block) == 4 and m.final_conv.in_channels == 24
    scans = [mod for mod in m.modules()
             if isinstance(mod, fusionmamba._ScanParams)]
    assert len(scans) == 2 * 15 + 4 and {s.d_state for s in scans} == {16}
    assert {(s.d_inner, s.dt_rank) for s in scans} == {
        (192, 6), (384, 12), (768, 24), (1536, 48)}
    rates = [b.drop_path.rate for s in m.layers for b in s.blocks]
    rates_up = [b.drop_path.rate for s in m.layers_up for b in s.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.1)
    assert rates_up == pytest.approx(rates[::-1])
    with pytest.raises(KeyError):
        create_fusion_model("vfefm")
