"""The port's SSD SS2D core against the JAX package's: forward and the
gradients of its four inputs, through the fused dirs path (its plain twin
here, the JAX kernel in Pallas interpret mode, the window widened to the
reduced shapes as the JAX tests do) and through the einsum path; the
cross-scan helpers and the gated RMSNorm."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd as jssd
import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
import medical_image_classification_tpu.ops.ss2d as jss2d
import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.ops.cross_scan as tcs
import medical_image_classification_tpu_torch.ops.ss2d as tss2d

# the JAX ops package exports a function named cross_scan, which hides the
# submodule from attribute access
jcs = importlib.import_module("medical_image_classification_tpu.ops.cross_scan")
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _window(monkeypatch):
    monkeypatch.setattr(jsfd, "_INTERPRET", True)
    monkeypatch.setattr(jsfd, "_MIN_L", 8)
    monkeypatch.setattr(tssd, "_MIN_L", 8)


def _core_args(B=2, HW=8, d_state=32, nheads=4, headdim=8, seed=0):
    """The JAX dirs test's reduced shape: d_ssm = 32 = gn, chunk 16 over
    L = 64 (four chunks: the mirrored-chunk maps)."""
    d_ssm = nheads * headdim
    rng = np.random.default_rng(seed)
    Cc = d_ssm + 2 * d_state + nheads
    arrs = [(0.5 * rng.standard_normal((B, HW, HW, Cc))).astype(np.float32),
            (0.5 * rng.random((4, nheads))).astype(np.float32),
            rng.random((4, nheads)).astype(np.float32),
            rng.random((4, nheads)).astype(np.float32)]
    kw = dict(d_ssm=d_ssm, d_state=d_state, nheads=nheads,
              headdim=headdim, chunk_size=16)
    return arrs, kw


def _off(monkeypatch):
    monkeypatch.setattr(jssd, "ssd_dirs_chunk", lambda *a, **k: None)
    monkeypatch.setattr(tss2d, "ssd_dirs_chunk", lambda *a, **k: None)


def _jax_fwd_grads(arrs, kw, dtype):
    x = jnp.asarray(arrs[0], dtype)
    ps = [jnp.asarray(a) for a in arrs[1:]]

    def f(x_, *p):
        return jss2d.ss2d_core_ssd(x_, *p, ngroups=1, **kw)

    y = f(x, *ps)
    grads = jax.grad(lambda *z: jnp.sum(f(*z).astype(jnp.float32) ** 2),
                     argnums=(0, 1, 2, 3))(x, *ps)
    return y, grads


def _torch_fwd_grads(arrs, kw, dtype):
    leaves = [torch.from_numpy(a).to(dtype if i == 0 else torch.float32)
              .requires_grad_(True) for i, a in enumerate(arrs)]
    y = tss2d.ss2d_core_ssd(*leaves, **kw)
    (y.float() ** 2).sum().backward()
    return y, [t.grad for t in leaves]


# fp32: 1e-4 of each output's scale (the dirs twin and the JAX kernel sum
# the same products in other orders); bf16 at the bf16 ladder
CASES = [("fp32", jnp.float32, torch.float32, 1e-4, 1e-4),
         ("bf16", jnp.bfloat16, torch.bfloat16, 3e-2, 5e-2)]


CORE_CASES = [("dirs", 4, 0), ("dirs", 8, 0), ("dirs", 4, 1),
              ("einsum", 4, 0), ("einsum", 4, 1)]


@pytest.mark.parametrize("path,nheads,case", CORE_CASES,
                         ids=[f"{p}-{h}-{CASES[c][0]}"
                              for p, h, c in CORE_CASES])
def test_core_ssd_matches_jax(monkeypatch, path, nheads, case):
    name, jdt, tdt, rtol, atol = CASES[case]
    arrs, kw = _core_args(nheads=nheads, seed=nheads)
    assert (tssd.ssd_dirs_chunk(64, 16, 128, 8, 4 * nheads, 8 * nheads)
            == 16)
    if path == "einsum":
        _off(monkeypatch)
    yj, gj = _jax_fwd_grads(arrs, kw, jdt)
    yt, gt = _torch_fwd_grads(arrs, kw, tdt)
    assert yt.dtype == tdt and yt.shape == yj.shape
    scale = lambda a: max(1.0, float(np.abs(np.asarray(a, np.float32)).max()))
    np.testing.assert_allclose(yt.detach().float().numpy(),
                               np.asarray(yj, np.float32), rtol=rtol,
                               atol=atol * (scale(yj) if name == "fp32"
                                            else 1.0))
    if name == "bf16":
        # bf16 gradients: rounding differences grow through the squares
        # of the loss; held against each other by leaf rel-norm instead
        for nm, g, w in zip(("dxBCdt", "dA_log", "ddt_bias", "dDs"), gt, gj):
            w = np.asarray(w, np.float32)
            err = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
            assert err < 3e-2, (nm, err)
        return
    for nm, g, w in zip(("dxBCdt", "dA_log", "ddt_bias", "dDs"), gt, gj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol * scale(w), err_msg=nm)


def test_dirs_and_einsum_paths_agree():
    """The port's two paths on the same inputs (fp32, 2e-5 as the JAX
    package's own dirs test)."""
    arrs, kw = _core_args(seed=7)
    x = [torch.from_numpy(a) for a in arrs]
    got = tss2d.ss2d_core_ssd(*x, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tss2d, "ssd_dirs_chunk", lambda *a, **k: None)
        want = tss2d.ss2d_core_ssd(*x, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_unported_options_raise():
    arrs, kw = _core_args()
    x = [torch.from_numpy(a) for a in arrs]
    for opt in (dict(merge=False),
                dict(bc_layout="per_direction"), dict(seq_axis="seq")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tss2d.ss2d_core_ssd(*x, **kw, **opt)


def test_cross_scan_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 20)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tcs.cross_scan_time_major(xt).numpy(),
                                  np.asarray(jcs.cross_scan_time_major(x)))
    np.testing.assert_array_equal(
        tcs.cross_scan_time_major2_roles(xt, 8, 4).numpy(),
        np.asarray(jcs.cross_scan_time_major2_roles(x, 8, 4)))
    ys = rng.standard_normal((2, 15, 4, 6)).astype(np.float32)
    yt = torch.from_numpy(ys)
    for tf, jf in ((tcs.cross_merge_time_major, jcs.cross_merge_time_major),
                   (tcs.cross_merge_noflip_time_major,
                    jcs.cross_merge_noflip_time_major)):
        np.testing.assert_allclose(tf(yt, 3, 5).numpy(),
                                   np.asarray(jf(ys, 3, 5)), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("shape,scale", [((3, 5, 16), 1.0),
                                         ((2, 4, 4, 64), 30.0)])
def test_rmsnorm_gated_matches_jax(shape, scale):
    """The models' setting (gate before the norm, one group): the JAX
    function's defaults, with group_size the full width as SS2DSSD passes
    it."""
    rng = np.random.default_rng(2)
    x, z = (scale * rng.standard_normal(shape).astype(np.float32)
            for _ in range(2))
    w = rng.random(shape[-1]).astype(np.float32)
    want = jss2d.rmsnorm_gated(x, z, w, group_size=shape[-1])
    got = tss2d.rmsnorm_gated(torch.from_numpy(x), torch.from_numpy(z),
                              torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
