"""FusionMamba of the port (``models/fusionmamba.py``, the EfficientScan
pair of ``ops/cross_scan.py``) against the JAX package's, on the CPU.

Weights go from JAX to the port: seeded numpy draws in each JAX module's
parameter structure (``jax.eval_shape`` of its init), the scan parameters
away from init and different for every sub-sequence k (A_logs log U(1,
16), Ds U(-1, 1), the dt biases the softplus-inverse of U(0.05, 0.5), per
element), the norms' scales, the biases and the LDC masks moved by N(0,
0.2), carried by ``vssm_fusion_state_dict_from_jax`` (and its per-module
writers) and loaded strictly.  Inputs come from a numpy seed.  Outputs
within 2e-3 x max|ref| (rtol 0); gradients of the parameters and inputs
within leaf rel-norm 2e-2 and cosine 0.998.

Covered: ``efficient_scan`` / ``efficient_merge`` and their round trip;
the plain scan twin's K 4 fold against JAX's generic ``selective_scan``
(A, D and the dt bias different per group), values and all seven
gradients; every module (the scan layers and blocks also with their
gradients); ``VSSMFusion`` at depths (1, 1), dims (16, 32), d_state 4,
32x32, batch 2, drop path 0: the eval output and every parameter's
gradient of the fusion loss (none for stage 0's cross block, which
nothing reads); bf16 compute against fp32 in distribution; float64 kept
to every gradient; the init distributions against Flax's own init; the
carrier's round trip through ``import_vssm_fusion_state_dict`` (d_state
16, which that importer reads for the blocks) bit for bit; and (slow) the
full-width registry model's parameters against the JAX model's."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.kernels.selective_scan import (
    selective_scan as jax_selective_scan,
)
from medical_image_classification_tpu.models import fusionmamba as jfm
from medical_image_classification_tpu.ops.cross_scan import (
    efficient_merge as jax_efficient_merge,
    efficient_scan as jax_efficient_scan,
)
from medical_image_classification_tpu.train.fusion_losses import (
    fusion_loss as jax_fusion_loss,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_vssm_fusion_state_dict,
)
from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    scan_folded_fwd,
)
from medical_image_classification_tpu_torch.models import create_fusion_model
from medical_image_classification_tpu_torch.models import fusionmamba as tfm
from medical_image_classification_tpu_torch.ops.cross_scan import (
    efficient_merge,
    efficient_scan,
)
from medical_image_classification_tpu_torch.train.fusion_losses import (
    fusion_loss,
)
from medical_image_classification_tpu_torch.utils import weights as tw
from test_torch_crossmamba import assert_scaled, flat_shapes, grads_close

torch.set_num_threads(2)

# dims 16 and 32: at dims 8 the final x4 expand's LayerNorm normalises
# two channels a pixel, so a pixel whose two channels nearly agree turns
# fp32 summation-order noise into O(1e-2) output differences
TINY = dict(depths=(1, 1), depths_decoder=(1, 1), dims=(16, 32),
            dims_decoder=(32, 16), d_state=4, drop_path_rate=0.0)
SIDE, BATCH = 32, 2


def perturb(tree, seed):
    """The JAX param tree with the leaves drawn away from init (see the
    module docstring), as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def leaf(name, v):
        v = np.array(v, np.float32)
        if name == "A_logs":
            return np.log(rng.uniform(1.0, 16.0, v.shape))
        if name == "Ds":
            return rng.uniform(-1.0, 1.0, v.shape)
        if name == "dt_projs_bias":
            dt = rng.uniform(0.05, 0.5, v.shape)
            return dt + np.log(-np.expm1(-dt))
        if name in ("bias", "scale", "learnable_mask", "learnable_theta"):
            return v + 0.2 * rng.standard_normal(v.shape)
        return v

    def walk(t):
        return {k: walk(v) if hasattr(v, "items")
                else leaf(k, v).astype(np.float32) for k, v in t.items()}
    return walk(tree)


def jax_params(module, *shapes, **kw):
    """Seeded params of the JAX ``module`` in its init's structure (from
    ``jax.eval_shape``, nothing compiled): kernels and projection weights
    N(0, 1 / fan_in), norm scales and LDC masks 1, biases 0, LDC theta
    0.5; then ``perturb``."""
    ins = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    tree = jax.eval_shape(lambda *x: module.init(
        jax.random.PRNGKey(0), *x, **kw), *ins).get("params", {})
    rng = np.random.default_rng(len(flat_shapes(tree)))

    def leaf(name, shape):
        if name in ("scale", "learnable_mask"):
            return np.ones(shape)
        if name in ("bias", "learnable_theta"):
            return np.full(shape, 0.5 if name == "learnable_theta" else 0.0)
        fan = np.prod(shape[:-1]) if name in ("kernel", "taps") \
            else shape[-1]
        return rng.standard_normal(shape) / np.sqrt(fan)

    def walk(t):
        return {k: walk(v) if hasattr(v, "items") else leaf(k, v.shape)
                for k, v in t.items()}
    return perturb(walk(tree), 4)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carried(write, params):
    """``write(h, "m", params)`` through the carrier's helpers, the "m."
    prefix dropped: the port's state_dict of one module."""
    sd = {}
    write(tw._writer(sd), "m", params)
    return {k[2:]: v for k, v in sd.items()}


# --- EfficientScan ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 6, 10, 5)])
def test_efficient_scan_and_merge_match_jax(shape):
    """Sub-sequence k takes row offset k % 2 and column offset k // 2; the
    merge writes each back; both as the JAX pair, and the round trip is
    the identity.  A side that is not even raises (the JAX pair fails)."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    xs = efficient_scan(torch.from_numpy(x))
    np.testing.assert_array_equal(xs.numpy(),
                                  np.asarray(jax_efficient_scan(x)))
    np.testing.assert_array_equal(xs[:, 1].numpy().reshape(
        shape[0], shape[1] // 2, shape[2] // 2, -1), x[:, 1::2, 0::2])
    ys = np.random.default_rng(1).standard_normal(xs.shape).astype(
        np.float32)
    np.testing.assert_array_equal(
        efficient_merge(torch.from_numpy(ys), *shape[1:3]).numpy(),
        np.asarray(jax_efficient_merge(ys, *shape[1:3])))
    np.testing.assert_array_equal(
        efficient_merge(xs, *shape[1:3]).numpy(), x)
    odd = np.zeros((1, 7, 8, 2), np.float32)
    with pytest.raises(ValueError, match="multiples of the step"):
        efficient_scan(torch.from_numpy(odd))
    with pytest.raises((TypeError, ValueError)):
        jax_efficient_scan(odd)


# --- the plain scan twin at K 4 ---------------------------------------------

def test_plain_twin_k4_fold_matches_jax_selective_scan():
    """The folded scan at G = batch x 4 (the group k = g % 4 binds A[k],
    D[k], bias[k], each different per group) through ``scan_folded_fwd``
    and its ``ScanFolded`` backward on the CPU (the plain twins), against
    JAX's generic ``selective_scan`` over the unfolded [batch, L, 4 Dm]
    layout with B/C per group: y and the gradients of u, Δ, A, B, C, D and
    the bias (dA, dD, dbias summed per group over the batch)."""
    batch, K, L, Dm, N = 2, 4, 37, 6, 4       # L: two chunks and a ragged one
    G = batch * K
    rng = np.random.default_rng(0)
    u, dl = (rng.standard_normal((G, L, Dm)).astype(np.float32)
             for _ in range(2))
    Bm, Cm = (rng.standard_normal((G, L, N)).astype(np.float32)
              for _ in range(2))
    A = -rng.uniform(0.5, 4.0, (K, Dm, N)).astype(np.float32)
    D = rng.uniform(-1, 1, (K, Dm)).astype(np.float32)
    bias = rng.uniform(-2, 0, (K, Dm)).astype(np.float32)
    w = rng.standard_normal((G, L, Dm)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (u, dl, A, Bm, Cm, D, bias)]
    y = scan_folded_fwd(*leaves)
    (y * torch.from_numpy(w)).sum().backward()

    def unfold(t):          # [G, L, c] -> [batch, L, K, c]
        return jnp.swapaxes(t.reshape(batch, K, L, t.shape[-1]), 1, 2)

    def jax_y(u, dl, A, Bm, Cm, D, bias):
        yg = jax_selective_scan(
            unfold(u).reshape(batch, L, K * Dm),
            unfold(dl).reshape(batch, L, K * Dm), A.reshape(K * Dm, N),
            unfold(Bm), unfold(Cm), D=D.reshape(-1),
            delta_bias=bias.reshape(-1), delta_softplus=True, impl="xla")
        return jnp.swapaxes(yg.reshape(batch, L, K, Dm), 1, 2).reshape(
            G, L, Dm)

    args = (u, dl, A, Bm, Cm, D, bias)
    want = np.asarray(jax_y(*args))
    assert_scaled(y.detach().numpy(), want)
    grads = jax.grad(lambda *a: jnp.sum(jax_y(*a) * w),
                     argnums=tuple(range(7)))(*args)
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
    grads_close({n: t.grad.numpy() for n, t in zip(names, leaves)},
                {n: np.asarray(g) for n, g in zip(names, grads)})


# --- the modules ------------------------------------------------------------

def _write_cross_layer(h, q, p):
    for name in ("texture_enhance1", "texture_enhance2"):
        tw._ldc(h, f"{q}.{name}", p[name])


def _write_taps(h, q, p):
    h["put"](q + ".taps", np.asarray(p["taps"]).transpose(3, 2, 0, 1))


# name: (JAX module, port module, input shapes, the carrier's writer,
# whether its apply takes ``train``, whether the gradients are checked)
MODULES = {
    "ss2d_efficient": (lambda: jfm.SS2DEfficient(8, d_state=4),
                       lambda: tfm.SS2DEfficient(8, d_state=4),
                       [(2, 8, 8, 8)], tw._ss2d_efficient, True, True),
    "ss2d_cross_efficient": (
        lambda: jfm.SS2DCrossEfficient(8, d_state=4),
        lambda: tfm.SS2DCrossEfficient(8, d_state=4),
        [(2, 8, 8, 8)] * 2, tw._cross_scan_layer, True, True),
    "ldc": (lambda: jfm.LDCConv(6), lambda: tfm.LDCConv(5, 6),
            [(2, 8, 8, 5)], tw._ldc, False, False),
    "differential_enhance": (jfm.DifferentialEnhance,
                             tfm.DifferentialEnhance, [(2, 8, 8, 6)] * 3,
                             lambda h, q, p: None, False, False),
    "cross_layer": (lambda: jfm.CrossLayer(6), lambda: tfm.CrossLayer(6),
                    [(2, 8, 8, 6)] * 3, _write_cross_layer, False, False),
    "biattn": (jfm.BiAttn, lambda: tfm.BiAttn(16), [(2, 8, 8, 16)],
               tw._biattn, False, False),
    "vss_block": (lambda: jfm.VSSBlockNew(8, d_state=4),
                  lambda: tfm.VSSBlockNew(8, d_state=4), [(2, 8, 8, 8)],
                  tw._vssblock_new, True, True),
    "vss_block_cross": (lambda: jfm.VSSBlockCrossNew(8, d_state=4),
                        lambda: tfm.VSSBlockCrossNew(8, d_state=4),
                        [(2, 8, 8, 8)] * 2, tw._cross_block, True, True),
    "cdc_hv": (lambda: jfm.CDCConvHV(6), lambda: tfm.CDCConvHV(5, 6),
               [(2, 8, 8, 5)], _write_taps, False, False),
    "cdc_diag": (lambda: jfm.CDCConvDiag(6), lambda: tfm.CDCConvDiag(5, 6),
                 [(2, 8, 8, 5)], _write_taps, False, False),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name):
    """The output, and for the scan layers and the blocks the gradient of
    sum(out w) over every parameter and input."""
    jmod_fn, tmod_fn, shapes, write, has_train, with_grads = MODULES[name]
    rng = np.random.default_rng(3)
    ins = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jmod = jmod_fn()
    kw = {"train": False} if has_train else {}
    params = jax_params(jmod, *shapes, **kw)
    port = tmod_fn()
    port.load_state_dict(carried(write, params), strict=True)
    run = lambda p, *x: jmod.apply({"params": p}, *x, **kw)
    w = rng.standard_normal(shapes[0]).astype(np.float32)
    if with_grads:
        want, (gp, gx) = jax.jit(lambda p, x: (run(p, *x), jax.grad(
            lambda p, x: jnp.sum(run(p, *x) * w), argnums=(0, 1))(p, x)))(
            params, ins)
    else:
        want = jax.jit(run)(params, *ins)
    leaves = [torch.from_numpy(a).requires_grad_(with_grads) for a in ins]
    got = port(*leaves)
    for g, wv in zip(*((got, want) if isinstance(got, tuple)
                       else ((got,), (want,)))):
        assert g.dtype == torch.float32
        assert_scaled(g.detach().numpy(), np.asarray(wv))
    if not with_grads:
        return
    (got * torch.from_numpy(w)).sum().backward()
    want = carried(write, to_np(gp))
    want.update({f"in{i}": np.asarray(g) for i, g in enumerate(gx)})
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    got.update({f"in{i}": t.grad.numpy() for i, t in enumerate(leaves)})
    grads_close(got, {k: np.asarray(v) for k, v in want.items()})


# --- the U-Net --------------------------------------------------------------

def _jax_unet(**kw):
    return jfm.VSSMFusion(**{**TINY, **kw})


@functools.lru_cache(maxsize=None)
def _jax_params(**kw):
    side = (BATCH, SIDE, SIDE, 1)
    return jax_params(_jax_unet(**kw), side, side, train=False)


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    # images in [0, 0.3]: the 2 (x1 + x2) residual keeps most of the fused
    # image under the clamp at 1, so the fusion loss has a gradient there
    return [0.3 * rng.random((BATCH, SIDE, SIDE, 1), dtype=np.float32)
            for _ in range(2)] + [rng.standard_normal(
                (BATCH, SIDE, SIDE, 1)).astype(np.float32)]


def _port_unet(dtype=None):
    port = create_fusion_model("fusionmamba", dtype=dtype, **TINY)
    port.load_state_dict(tw.vssm_fusion_state_dict_from_jax(_jax_params()),
                         strict=True)
    return port


@functools.lru_cache(maxsize=None)
def _jax_unet_results():
    params = _jax_params()
    model = _jax_unet()
    xa, xb, w = _unet_inputs(1)

    def run(p):
        def loss(p):
            y = model.apply({"params": p}, xa, xb, train=True)
            return jax_fusion_loss(xa, xb, jnp.clip(y, 0.0, 1.0))[0]
        out = model.apply({"params": p}, xa, xb, train=False)
        return out, jax.value_and_grad(loss)(p)

    out, (loss, grads) = jax.jit(run)(params)
    return np.asarray(out), float(loss), to_np(grads)


def _grads(model):
    """Every parameter's gradient; zeros where the loss does not reach
    it (``Cross_block.0``: JAX's gradient there is zero)."""
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            .double().numpy() for n, p in model.named_parameters()}


def test_unet_matches_jax():
    """The eval fused image, then in train mode the fusion step's loss
    (clamp to [0, 1], ``fusion_loss``) and every parameter's gradient;
    stage 0's cross block gets none on both sides."""
    out_j, loss_j, grads_j = _jax_unet_results()
    xa, xb, _ = (torch.from_numpy(a) for a in _unet_inputs(1))
    port = _port_unet()
    with torch.no_grad():
        out = port.eval()(xa, xb)
    assert out.dtype == torch.float32 and out.shape == (BATCH, SIDE, SIDE, 1)
    assert_scaled(out.numpy(), out_j)
    port.train()
    loss = fusion_loss(xa, xb, port(xa, xb).clamp(0.0, 1.0))[0]
    loss.backward()
    assert abs(float(loss.detach()) - loss_j) <= 2e-3 * abs(loss_j)
    want = tw.vssm_fusion_state_dict_from_jax(grads_j)
    got = _grads(port)
    assert set(got) == set(want)
    unreached = {n for n, p in port.named_parameters() if p.grad is None}
    assert unreached and all(n.startswith("Cross_block.0.")
                             for n in unreached)
    assert all(not want[n].any() for n in unreached)
    grads_close(got, {n: want[n].numpy() for n in got})


def test_unet_bf16_compute():
    """bf16 compute, fp32 parameters: the fused image comes back fp32,
    finite, and tracks the fp32 one (the JAX test's bounds)."""
    xa, xb, _ = (torch.from_numpy(a) for a in _unet_inputs(1))
    with torch.no_grad():
        a = _port_unet().eval()(xa, xb).numpy().ravel()
        bf16 = _port_unet(torch.bfloat16).eval()
        assert all(p.dtype == torch.float32 for p in bf16.parameters())
        b = bf16(xa, xb)
    assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
    b = b.numpy().ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.99
    assert float(np.mean(np.abs(a - b))) < 0.1 * (float(np.std(a)) + 1e-6)


def test_unet_float64_keeps_float64():
    """The exact reference of a gradient check: the model and inputs in
    float64 stay float64 to the fused image and every gradient (the scan
    through its plain twin in float64) and agree with fp32."""
    xa, xb, w = (torch.from_numpy(a) for a in _unet_inputs(1))
    port = _port_unet().train()
    outs, grads = {}, {}
    for dt in (torch.float32, torch.float64):
        model = port.to(dt)
        model.zero_grad(set_to_none=True)
        outs[dt] = model(xa.to(dt), xb.to(dt))
        (outs[dt] * w.to(dt)).mean().backward()
        assert outs[dt].dtype == dt
        grads[dt] = _grads(model)
        assert all(p.grad.dtype == dt for p in model.parameters()
                   if p.grad is not None)
    assert_scaled(outs[torch.float32].detach().numpy(),
                  outs[torch.float64].detach().numpy())
    grads_close(grads[torch.float32], grads[torch.float64])


def test_init_distributions_match_flax():
    """The port's seeded init against Flax's at dims 32/64: every leaf
    that Flax initialises to a constant (ones, zeros, S4D A_logs, theta
    0.5) bit for bit; the dt biases one draw repeated over the four k on
    both sides; every random leaf's mean and std within its sampling
    error (trunc-normal(0.02) has std 0.0176, not 0.02)."""
    kw = dict(depths=(1, 1), depths_decoder=(1, 1), dims=(32, 64),
              dims_decoder=(64, 32), d_state=16)
    x = jnp.zeros((1, 16, 16, 1))
    params = jax.jit(lambda x: jfm.VSSMFusion(**kw).init(
        jax.random.PRNGKey(0), x, x, train=False))(x)["params"]
    want = tw.vssm_fusion_state_dict_from_jax(to_np(params))
    got = create_fusion_model("fusionmamba", generator=torch.Generator()
                              .manual_seed(0), **kw).state_dict()
    assert set(got) == set(want)
    pools = {}          # leaves of one name (the indices dropped) and shape
    for k, wv in want.items():
        g, wv = got[k].double().numpy().ravel(), wv.double().numpy().ravel()
        if k.endswith("dt_projs_bias"):
            # one draw of D values, repeated over the four k
            for t in (got[k], want[k]):
                assert torch.equal(t, t[:1].expand_as(t)), k
            g, wv = g[:g.size // 4], wv[:wv.size // 4]
        if wv.std() == 0:
            np.testing.assert_array_equal(g, wv, err_msg=k)
            continue
        pool = pools.setdefault((re.sub(r"\.\d+\.", ".", k), got[k].shape),
                                ([], []))
        pool[0].append(g)
        pool[1].append(wv)
    for k, (g, wv) in pools.items():
        g, wv = np.concatenate(g), np.concatenate(wv)
        n = wv.size         # two samples of n: their difference
        assert abs(g.std() / wv.std() - 1) < 4 / np.sqrt(n) + 0.02, k
        assert abs(g.mean() - wv.mean()) < 4 * wv.std() * np.sqrt(2 / n), k


def test_carrier_round_trip():
    """JAX params -> the port's state_dict (a strict load) ->
    ``import_vssm_fusion_state_dict``: every JAX leaf back bit for bit, at
    two encoder and two decoder stages (d_state 16)."""
    params = _jax_params(d_state=16)
    sd = tw.vssm_fusion_state_dict_from_jax(params)
    create_fusion_model("fusionmamba", **{**TINY, "d_state": 16}
                        ).load_state_dict(sd, strict=True)
    back = import_vssm_fusion_state_dict(
        {k: v.numpy() for k, v in sd.items()}, depths=(1, 1),
        depths_decoder=(1, 1), dims=(16, 32), d_state=16)
    flat = lambda t, pre="": {
        k2: v2 for k, v in t.items() for k2, v2 in (
            flat(v, f"{pre}{k}/").items() if hasattr(v, "items")
            else [(pre + k, v)])}
    fp, fb = flat(params), flat(back)
    assert set(fp) == set(fb)
    for k, v in fp.items():
        np.testing.assert_array_equal(np.asarray(fb[k]), v, err_msg=k)
        assert np.asarray(fb[k]).dtype == v.dtype, k


@pytest.mark.slow
def test_full_width_parameters_match_jax():
    """``create_fusion_model("fusionmamba")`` (meta tensors) has the JAX
    full-width model's parameters: as many leaves, the same count, and
    each top-level module's count."""
    x = jax.ShapeDtypeStruct((1, 64, 64, 1), jnp.float32)
    shapes = jax.eval_shape(lambda x: jfm.VSSMFusion().init(
        jax.random.PRNGKey(0), x, x, train=False), x)["params"]
    with torch.device("meta"):
        port = create_fusion_model("fusionmamba")
    jax_sizes = {k: int(np.prod(s)) for k, s in flat_shapes(shapes).items()}
    assert len(list(port.parameters())) == len(jax_sizes)
    assert sum(p.numel() for p in port.parameters()) == \
        sum(jax_sizes.values())
    top = lambda k: k.split("/")[0]
    per_jax = {}
    for k, n in jax_sizes.items():
        per_jax[top(k)] = per_jax.get(top(k), 0) + n
    per_port = {}
    for n, p in port.named_parameters():
        parts = n.split(".")
        if parts[0] in ("layers", "layers_up"):
            key = (f"{parts[0]}_{parts[1]}_{parts[2]}_{parts[3]}"
                   if parts[2] == "blocks" else
                   f"{parts[0]}_{parts[1]}_{parts[2]}")
        elif parts[0] == "Cross_block":
            key = f"cross_block_{parts[1]}"
        else:
            key = parts[0]
        per_port[key] = per_port.get(key, 0) + p.numel()
    assert per_port == per_jax


def test_chip_smoke_profile_counts_kernels_not_annotation_spans(
        monkeypatch):
    """chip_smoke.py's profile rows: kernels (no CPU time) and ops are kept;
    a record_function region's span on the device (the optimizer step's:
    its name, no CPU time), which lies over kernels already counted, is
    dropped, by its name or by its annotation flag, so a step's device
    time counts each kernel once (on an H100 the Adam step's span was
    19.53 of FusionMamba's 90.87 ms)."""
    import types

    import chip_smoke

    def ev(key, dev, cpu, annotation=False):
        return types.SimpleNamespace(key=key, count=1, device_time_total=dev,
                                     cpu_time_total=cpu,
                                     is_user_annotation=annotation)

    events = [ev("Optimizer.step#Adam.step", 0.0, 900.0, True),
              ev("Optimizer.step#Adam.step", 19530.0, 0.0, True),
              ev("ProfilerStep#1", 5000.0, 0.0, True),
              ev("aten::add", 400.0, 30.0),
              ev("multi_tensor_apply_kernel", 19000.0, 0.0),
              ev("scan_fwd_chunk_kernel", 1100.0, 0.0)]

    class Prof:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def key_averages(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = []
    rows = chip_smoke._profile(lambda: calls.append(1))
    assert len(calls) == 2                  # a warm-up, then the window
    assert [(r["name"], r["cpu_us"] == 0.0) for r in rows] == [
        ("multi_tensor_apply_kernel", True),
        ("scan_fwd_chunk_kernel", True), ("aten::add", False),
        ("Optimizer.step#Adam.step", False)]
    total, times = chip_smoke._step_profile(lambda: None,
                                            chip_smoke.SCAN_SPLIT)
    assert total == pytest.approx(20.1)
    assert times["scan forward"] == pytest.approx(1.1)


def test_chip_smoke_float64_gate_checks_leaves_under_the_vfefm_floor():
    """chip_smoke.py's float64 gradient gate at FusionMamba's abs floor
    (FM_GRAD_FLOOR, 0): where every leaf's error lies under the vfefm
    U-Nets' floor (PARAM_GRAD_TOL's 2e-4; FusionMamba's fusion loss on
    the card), a leaf turned against its reference, or 12% off where the
    plain twins are 3% off, still fails, a leaf 6% off there passes, and
    only a leaf with no error at all (stage 0's unread cross block) goes
    unchecked; at 2e-4 the same gate checks nothing and raises."""
    import chip_smoke
    rng = np.random.default_rng(0)
    exact = {f"leaf{i}": torch.from_numpy(1e-6 * rng.standard_normal(64))
             for i in range(4)}
    exact["unread"] = torch.zeros(8, dtype=torch.float64)

    def off(rel, seed):
        r = np.random.default_rng(seed)
        return dict({k: v + rel[i] * v.norm() / 8 * torch.from_numpy(
                     r.standard_normal(64))
                     for i, (k, v) in enumerate(exact.items())
                     if k != "unread"}, unread=exact["unread"])

    def check(got, floor=chip_smoke.FM_GRAD_FLOOR):
        return chip_smoke._check_grad_tree_exact(
            "t", got, plain, exact, *chip_smoke.PARAM_GRAD_TOL[:2], floor)

    assert chip_smoke.FM_GRAD_FLOOR == 0.0
    plain = off([0.03, 0.001, 0.0, 0.0], 1)
    got = off([0.06, 0.01, 0.001, 0.0], 2)
    assert max(float((got[n] - exact[n]).norm()) for n in got) < \
        chip_smoke.PARAM_GRAD_TOL[2]
    _, _, st = check(got)
    assert st["kernels"]["leaves_over_floor"] == 3
    for bad in ([0.12, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.5]):
        with pytest.raises(AssertionError, match="leaves beyond"):
            check(off(bad, 3))
    with pytest.raises(AssertionError, match="leaves beyond"):
        check(dict(exact, leaf3=-exact["leaf3"]))
    with pytest.raises(AssertionError, match="checks none"):
        check(dict(exact, leaf3=-exact["leaf3"]),
              chip_smoke.PARAM_GRAD_TOL[2])
    with pytest.raises(AssertionError, match="checks none"):
        check(exact)


def test_chip_smoke_path_grads_zero_fill_only_fusionmamba_unused():
    """chip_smoke.py's gradient trees: a parameter without a gradient is
    zeros only where it is FusionMamba's unread stage-0 cross block
    (FM_UNUSED); anywhere else, and in any other model, it raises."""
    import chip_smoke
    p = torch.nn.Parameter(torch.ones(3))
    assert torch.equal(chip_smoke._grad_of(
        "fusionmamba", "Cross_block.0.ln_1.weight", p), torch.zeros(3))
    for name, n in (("fusionmamba", "Cross_block.1.ln_1.weight"),
                    ("fusionmamba", "layers.0.blocks.0.op.Ds"),
                    ("vfefm_2b2", "Cross_block.0.ln_1.weight")):
        with pytest.raises(AssertionError, match="does not reach"):
            chip_smoke._grad_of(name, n, p)
    p.grad = torch.full((3,), 2.0)
    assert chip_smoke._grad_of("vfefm_2b2", "x", p) is p.grad


def test_scan_folded_fwd_keeps_float64_on_the_plain_route():
    """``scan_folded_fwd`` with a float64 u and impl "torch" (the float64
    reference of the gradient gate, at K 4) runs the plain version in
    float64, parameters too, under torch.autograd: y and every gradient
    float64 and within the file's tolerances of the fp32 call;
    ``impl="cuda"`` still refuses a CPU tensor."""
    G, L, Dm, N = 8, 21, 6, 4
    rng = np.random.default_rng(5)
    ins = [rng.standard_normal(s).astype(np.float32) for s in
           ((G, L, Dm), (G, L, Dm), (G, L, N), (G, L, N))]
    A = -rng.uniform(0.5, 4.0, (4, Dm, N)).astype(np.float32)
    D, bias = (rng.uniform(-1, 0, (4, Dm)).astype(np.float32)
               for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((G, L, Dm)))
    ys, gs = {}, {}
    for dt in (torch.float32, torch.float64):
        u, dl, Bm, Cm = (torch.tensor(a, dtype=dt, requires_grad=True)
                         for a in ins)
        prm = [torch.tensor(a, requires_grad=True) for a in (A, D, bias)]
        ys[dt] = scan_folded_fwd(u, dl, prm[0], Bm, Cm, prm[1], prm[2],
                                 impl="torch")
        (ys[dt] * w.to(dt)).sum().backward()
        assert ys[dt].dtype == dt
        gs[dt] = {n: t.grad for n, t in zip(
            ("du", "ddelta", "dB", "dC", "dA", "dD", "dbias"),
            (u, dl, Bm, Cm, *prm))}
    assert all(g.dtype == torch.float64 for n, g in gs[torch.float64].items()
               if n in ("du", "ddelta", "dB", "dC"))
    assert_scaled(ys[torch.float32].detach().numpy(),
                  ys[torch.float64].detach().numpy())
    grads_close({n: g.double().numpy() for n, g in gs[torch.float32].items()},
                {n: g.double().numpy() for n, g in gs[torch.float64].items()})
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        scan_folded_fwd(*(torch.from_numpy(a).double() for a in ins[:2]),
                        torch.from_numpy(A), *(torch.from_numpy(a).double()
                                               for a in ins[2:]),
                        torch.from_numpy(D), torch.from_numpy(bias),
                        impl="cuda")
