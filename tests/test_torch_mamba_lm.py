"""The port's Mamba-1 LM against the JAX package's, at a reduced config.

The same parameters (JAX init, carried by ``mamba_lm_state_dict``) and the
same token ids go through ``models/mamba_lm.py`` of both packages: logits,
the whole gradient tree, decoding against the full forward, greedy
``generate`` and the scan's last state, with RMSNorm and with LayerNorm.
Also the carrier (an exact round trip through
``import_mamba_lm_state_dict``, a synthetic HF-format ``state_dict``), the
init distributions, the launches per forward with the CUDA route stood in
for by the plain versions, the refusals without a card, and that the LM
path imports no JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.models import mamba_lm as jlm
from medical_image_classification_tpu.utils.torch_import import (
    import_mamba_lm_state_dict,
)
from medical_image_classification_tpu_torch.kernels import (
    selective_scan_bwd as bwd,
    selective_scan_fwd as fwd,
)
from medical_image_classification_tpu_torch.models import mamba_lm as tlm
from medical_image_classification_tpu_torch.utils.weights import (
    mamba_lm_state_dict,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, BATCH, L = 50, 2, 12


def _cfg(rms_norm=True, d_model=16):
    return dict(d_model=d_model, n_layer=2, vocab_size=VOCAB, d_state=4,
                rms_norm=rms_norm)


def _ids(seed, batch=BATCH, length=L):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, length),
                                                dtype=np.int32)


def _perturb(params, seed):
    """Scan parameters away from init (D, Δ bias, A_log drawn afresh), so
    the checks see the state term."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, layer in params.items():
        if not name.startswith("layers_"):
            continue
        m = layer["mixer"]
        m["D"] = rng.uniform(-1, 1, m["D"].shape).astype(np.float32)
        dt = rng.uniform(0.05, 0.5, m["dt_proj_bias"].shape)
        m["dt_proj_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        m["A_log"] = np.log(rng.uniform(1, 8, m["A_log"].shape)).astype(
            np.float32)
    return params


def _pair(rms_norm=True, seed=0, d_model=16):
    """(JAX model, its params, the port model with the same weights)."""
    cfg = _cfg(rms_norm, d_model)
    jmodel = jlm.MambaLMHeadModel(jlm.MambaConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(_ids(0)))
    params = _perturb(params["params"], seed + 1)
    tmodel = tlm.MambaLMHeadModel(tlm.MambaConfig(**cfg), device="cpu")
    tmodel.load_state_dict(mamba_lm_state_dict(params), strict=True)
    return jmodel, params, tmodel


def _scaled_close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) + 1e-12
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("rms_norm", [True, False])
def test_logits_and_gradient_tree_match_jax(rms_norm):
    """Logits within 2e-3 x max|logit|, and the gradient of a fixed random
    projection of the logits with respect to every parameter (the tied
    embedding carries both of its uses) within 2e-3 x max|leaf| per leaf;
    LayerNorm's eps (1e-6, Flax's) and bias included when ``rms_norm`` is
    off."""
    jmodel, params, tmodel = _pair(rms_norm)
    ids = _ids(1)
    w = np.random.default_rng(2).standard_normal(
        (BATCH, L, tmodel.config.padded_vocab)).astype(np.float32)

    def loss_j(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids))
        return jnp.sum(logits * w), logits

    (_, logits_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    grads_j = mamba_lm_state_dict(grads_j)

    logits_t = tmodel(torch.from_numpy(ids).long())
    (logits_t * torch.from_numpy(w)).sum().backward()
    _scaled_close(logits_t.detach().numpy(), logits_j, 2e-3, "logits")
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(names) == set(grads_j) - {"lm_head.weight"}
    for name, p in tmodel.named_parameters():
        _scaled_close(p.grad.numpy(), grads_j[name].numpy(), 2e-3, name)


@pytest.mark.parametrize("rms_norm", [True, False])
def test_decode_and_last_state_match_the_full_forward(rms_norm):
    """decode_step over the sequence gives the full forward's logits, the
    port's within 1e-4 x max|logit| and JAX's within 2e-3; each layer's
    Mamba(return_state=True) last state equals the decode cache's ssm
    after the same tokens (1e-5), and JAX's Mamba last state."""
    jmodel, params, tmodel = _pair(rms_norm, seed=3)
    ids = _ids(4)
    logits_j = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = tmodel(ids_t)
        cache = tmodel.init_cache(BATCH)
        steps = []
        for t in range(L):
            logits, cache = tmodel.decode_step(ids_t[:, t], cache)
            steps.append(logits)
        dec = torch.stack(steps, dim=1)
        _scaled_close(dec.numpy(), full.numpy(), 1e-4, "decode vs forward")
        _scaled_close(dec.numpy(), logits_j, 2e-3, "decode vs JAX")
        assert cache[1].shape == (2, BATCH, 32, 4)
        h = tmodel.backbone.embedding(ids_t)
        for i, blk in enumerate(tmodel.backbone.layers):
            y, last = blk.mixer(blk.norm(h), return_state=True)
            torch.testing.assert_close(last, cache[1][i], rtol=1e-5,
                                       atol=1e-5)
            normed = jnp.asarray(blk.norm(h).numpy())
            _, last_j = jlm.Mamba(16, d_state=4).apply(
                {"params": params[f"layers_{i}"]["mixer"]}, normed,
                return_state=True)
            np.testing.assert_allclose(last.numpy(), np.asarray(last_j),
                                       rtol=1e-4, atol=1e-4)
            h = h + y


def test_greedy_generate_matches_jax():
    """Greedy generation: the same tokens as JAX's generate, and each new
    token the argmax of the full forward over the generated sequence."""
    jmodel, params, tmodel = _pair(seed=5, d_model=32)
    prompt = _ids(6, length=5)
    want = np.asarray(jlm.generate(jmodel, {"params": params},
                                   jnp.asarray(prompt), max_new_tokens=6))
    got = tlm.generate(tmodel, torch.from_numpy(prompt), max_new_tokens=6)
    assert got.shape == (BATCH, 11) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        full = tmodel(got)
    assert torch.equal(full[:, 4:-1].argmax(-1), got[:, 5:])


def test_sampling_is_seeded_and_top_k_masks():
    """temperature > 0 samples from the generator (the same seed, the same
    tokens); top_k 1 is greedy."""
    _, _, tmodel = _pair(seed=7)
    prompt = torch.from_numpy(_ids(8, length=3))
    draw = lambda seed, **kw: tlm.generate(
        tmodel, prompt, max_new_tokens=5, temperature=1.5,
        generator=torch.Generator().manual_seed(seed), **kw)
    assert torch.equal(draw(1), draw(1))
    assert torch.equal(draw(2, top_k=1),
                       tlm.generate(tmodel, prompt, max_new_tokens=5))


def test_carrier_round_trip_and_hf_dict():
    """mamba_lm_state_dict then import_mamba_lm_state_dict gives back the
    JAX params exactly; a port state_dict() imports into a JAX model with
    the same logits; a synthetic HF-format Mamba-1 state_dict (embedding
    already padded, no lm_head.weight) loads strictly and gives JAX's
    logits from the same dict."""
    _, params, tmodel = _pair(seed=9)
    back = import_mamba_lm_state_dict(mamba_lm_state_dict(params), n_layer=2)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    want, got = flat(params), flat(back)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    cfg = jlm.MambaConfig(d_model=16, n_layer=2, vocab_size=48, d_state=4)
    g = torch.Generator().manual_seed(2)
    sd = {}

    def add(name, *shape):
        sd[name] = 0.3 * torch.randn(*shape, generator=g)

    add("backbone.embedding.weight", 48, 16)
    add("backbone.norm_f.weight", 16)
    for i in range(2):
        p = f"backbone.layers.{i}"
        add(p + ".norm.weight", 16)
        add(p + ".mixer.in_proj.weight", 64, 16)
        add(p + ".mixer.conv1d.weight", 32, 1, 4)
        add(p + ".mixer.conv1d.bias", 32)
        add(p + ".mixer.x_proj.weight", 1 + 8, 32)
        add(p + ".mixer.dt_proj.weight", 32, 1)
        add(p + ".mixer.dt_proj.bias", 32)
        add(p + ".mixer.A_log", 32, 4)
        add(p + ".mixer.D", 32)
        add(p + ".mixer.out_proj.weight", 16, 32)
    port = tlm.MambaLMHeadModel(tlm.MambaConfig(
        d_model=16, n_layer=2, vocab_size=48, d_state=4), device="cpu")
    port.load_state_dict(sd, strict=True)
    assert port.lm_head.weight is port.backbone.embedding.weight
    ids = _ids(10) % 48
    want = jlm.MambaLMHeadModel(cfg).apply(
        {"params": import_mamba_lm_state_dict(
            {k: v.numpy() for k, v in sd.items()}, n_layer=2)},
        jnp.asarray(ids))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    _scaled_close(got.numpy(), want, 2e-3, "HF dict logits")


def test_init_distributions_match_jax():
    """The port's seeded init draws from the JAX module's distributions:
    A_log, D and the norms are equal, the random leaves agree in mean and
    spread (5 sigma; Flax's truncated_normal(0.02) has std 0.0176)."""
    cfg = _cfg(d_model=64)
    ref = jlm.MambaLMHeadModel(jlm.MambaConfig(**cfg)).init(
        jax.random.PRNGKey(4), jnp.asarray(_ids(0)))["params"]
    port = tlm.MambaLMHeadModel(tlm.MambaConfig(**cfg), device="cpu",
                                generator=torch.Generator().manual_seed(4))
    want = mamba_lm_state_dict(ref)
    got = port.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        w, gk = w.double().numpy(), got[k].double().numpy()
        assert w.shape == gk.shape, k
        if w.std() == 0 or k.endswith("A_log"):
            np.testing.assert_array_equal(gk, w, err_msg=k)
        elif w.size >= 256:
            n = w.size
            assert abs(gk.std() / w.std() - 1) < 5 / np.sqrt(n), k
            assert abs(gk.mean() - w.mean()) < 5 * w.std() * np.sqrt(2 / n), k
    assert abs(got["backbone.embedding.weight"].std() - 0.0176) < 2e-3


def test_launches_per_forward_on_the_cuda_route(monkeypatch):
    """On the CUDA route (the launches stood in for by the plain versions,
    the route forced on CPU tensors), a forward launches the scan forward
    once per layer and nothing else; a gradient step once forward and once
    backward per layer, dlast on the path through return_state; the
    logits equal the plain route's."""
    from test_torch_scan_flags import _fake_launches
    _, _, tmodel = _pair(seed=11)
    ids = torch.from_numpy(_ids(12)).long()
    with torch.no_grad():
        want = tmodel(ids)
    _fake_launches(monkeypatch)
    f0, b0 = fwd.scan_folded_fwd.launches, bwd.scan_folded_bwd.launches
    with torch.no_grad():
        got = tmodel(ids)
    assert (fwd.scan_folded_fwd.launches - f0,
            bwd.scan_folded_bwd.launches - b0) == (2, 0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    h = tmodel.backbone.embedding(ids)
    loss = 0.0
    for blk in tmodel.backbone.layers:
        y, last = blk.mixer(blk.norm(h), return_state=True)
        h = h + y
        loss = loss + (last ** 2).mean()
    (tmodel.lm_head(tmodel.backbone.norm_f(h)).square().mean()
     + loss).backward()
    assert (fwd.scan_folded_fwd.launches - f0,
            bwd.scan_folded_bwd.launches - b0) == (4, 2)
    assert all(p.grad is not None for p in tmodel.parameters())


def test_no_card_no_fallback(monkeypatch):
    """Without a card the model (built on "cuda" by default) raises as the
    CLIs do, and the kernel route refuses CPU tensors: nothing falls back
    to the CPU or to the plain scan."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.MambaLMHeadModel(tlm.MambaConfig(**_cfg()))
    model = tlm.MambaLMHeadModel(tlm.MambaConfig(**_cfg()), scan_impl="cuda",
                                 device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        model(torch.from_numpy(_ids(0)).long())


def test_lm_path_imports_no_jax():
    """The model, the carrier and generate, run in a fresh interpreter,
    load no module of jax, flax, optax or the JAX package."""
    code = (
        "import sys, torch\n"
        "from medical_image_classification_tpu_torch.models import "
        "mamba_lm as m\n"
        "from medical_image_classification_tpu_torch.utils import weights\n"
        "cfg = m.MambaConfig(d_model=16, n_layer=2, vocab_size=50, "
        "d_state=4)\n"
        "model = m.MambaLMHeadModel(cfg, device='cpu')\n"
        "out = m.generate(model, torch.zeros(1, 3, dtype=torch.long), 2)\n"
        "assert out.shape == (1, 5)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', "
        "'medical_image_classification_tpu'))\n"
        "assert not bad, bad\n"
        "print('LM_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "LM_OK" in proc.stdout, proc.stderr
