"""The v1 scan kernels' decomposition in plain PyTorch, against the plain
versions and the JAX package.

``scan_v1_fwd_walk_ref`` (every state walked through time, xsave where a
chunk begins) and ``scan_v1_bwd_pieces_ref`` (each chunk seeded from the
xsave it is given, a checkpoint walk, the pieces recomputed and swept back
to front, dB and dC added over groups of 32 channels) restate
what csrc/selective_scan_v1_{fwd,bwd}.cu compute.  They are held against
the doubling-scan plain versions ``scan_v1_{fwd,bwd}_ref`` and against the
JAX package's ``_fwd_folded`` / ``bwd_folded`` (Pallas interpret mode, as
tests/test_pallas_scan.py runs them) at chunks of 1, 7, 33 and 50 steps
over ragged lengths, N 4, 16 and 64, channel counts that leave a block of 32
short, and an xsave that is not the forward's (the backward must take each
chunk's states from the xsave it is given).  fp32 within 1e-4 of each
output's largest entry (only the order of the sums differs); bf16 inputs
within rtol 3e-2, atol 5e-2 of it (y rounds to bf16 on both sides, and
lands a bf16 step apart where the sums straddle a rounding point).  Also
chip_smoke's v1 bounds at the bench's stage 0, its profile names against
the CUDA sources, and the twins' constants against the kernels'."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.selective_scan_pallas as ssp
import medical_image_classification_tpu.kernels.selective_scan_pallas_bwd as sspb  # noqa: E501
from medical_image_classification_tpu_torch.kernels import (
    selective_scan_v1 as v1,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "medical_image_classification_tpu_torch" / "csrc"
NAMES = ("u", "delta", "A", "B", "C", "D", "bias")
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
# (batch, K, L, Dm, N, T): every chunk length over a ragged L (T 1 makes
# each step a chunk); Dm 40 and 36 leave the second group of 32 channels
# short, Dm 72 the third; N 4, 16, 64 (the kernels' widths 8, 16, 64)
CASES = [(1, 2, 13, 40, 4, 1), (1, 2, 30, 36, 16, 7), (1, 1, 70, 40, 64, 33),
         (1, 2, 123, 72, 16, 50)]
IDS = [f"T{c[5]}-L{c[2]}-Dm{c[3]}-N{c[4]}" for c in CASES]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    monkeypatch.setattr(sspb, "_INTERPRET", True)


def _inputs(seed, batch, K, L, Dm, N):
    """Folded scan inputs, a cotangent dy and noise of xsave's shape (at
    chunk T filled in by the caller), as numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    G = batch * K
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = dict(u=f(G, L, Dm), delta=0.5 * f(G, L, Dm),
               A=-np.exp(0.5 * f(K, Dm, N)), B=f(G, L, N), C=f(G, L, N),
               D=f(K, Dm), bias=0.1 * f(K, Dm))
    return inp, f(G, L, Dm), rng


def _close(got, want, what, rtol=1e-4, atol=1e-4):
    got, want = (np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                            np.float32) for t in (got, want))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("batch,K,L,Dm,N,T", CASES, ids=IDS)
def test_walk_forward_matches_plain_and_jax(batch, K, L, Dm, N, T):
    """y and xsave of the one-walk-per-state twin against the doubling-scan
    plain forward and the JAX ``_fwd_folded``."""
    inp, _, _ = _inputs(L + T, batch, K, L, Dm, N)
    args = [torch.from_numpy(inp[k]) for k in NAMES]
    y_w, x_w = v1.scan_v1_fwd_walk_ref(*args, T)
    y_p, x_p = v1.scan_v1_fwd_ref(*args, T)
    y_j, x_j = ssp._fwd_folded(*[jnp.asarray(inp[k]) for k in NAMES], T, Dm)
    assert tuple(x_w.shape) == tuple(x_p.shape) == x_j.shape
    for want, src in ((y_p, "plain"), (np.asarray(y_j), "jax")):
        _close(y_w, want, f"y vs {src}")
    for want, src in ((x_p, "plain"), (np.asarray(x_j), "jax")):
        _close(x_w, want, f"xsave vs {src}")


@pytest.mark.parametrize("perturbed", [False, True], ids=["xsave", "noisy"])
@pytest.mark.parametrize("batch,K,L,Dm,N,T", CASES, ids=IDS)
def test_pieces_backward_matches_plain_and_jax(batch, K, L, Dm, N, T,
                                               perturbed):
    """All seven gradients of the pieces-and-sweep twin against the plain
    backward and the JAX ``bwd_folded``, from the forward's xsave and from
    one with seeded noise added: the three agree on the noisy one too, and
    its gradients differ from the forward's (each chunk's states come from
    the xsave given, not from a walk from zero)."""
    inp, dy, rng = _inputs(7 * L + T, batch, K, L, Dm, N)
    args = [torch.from_numpy(inp[k]) for k in NAMES]
    _, xsave = v1.scan_v1_fwd_ref(*args, T)
    if perturbed:
        xsave = xsave + torch.from_numpy(
            rng.standard_normal(tuple(xsave.shape)).astype(np.float32))
    dyt = torch.from_numpy(dy)
    g_w = v1.scan_v1_bwd_pieces_ref(*args, xsave, dyt, T)
    g_p = v1.scan_v1_bwd_ref(*args, xsave, dyt, T)
    g_j = sspb.bwd_folded(*[jnp.asarray(inp[k]) for k in NAMES],
                          jnp.asarray(xsave.numpy()), jnp.asarray(dy), T, Dm)
    for name, gw, gp, gj, p in zip(GRADS, g_w, g_p, g_j, args):
        assert gw.dtype == torch.float32 and gw.shape == p.shape, name
        _close(gw, gp, f"{name} vs plain")
        _close(gw, np.asarray(gj), f"{name} vs jax")
    if perturbed:
        _, x0 = v1.scan_v1_fwd_ref(*args, T)
        g0 = v1.scan_v1_bwd_pieces_ref(*args, x0, dyt, T)
        assert max(float((a - b).abs().max()) for a, b in zip(g_w, g0)) > 0.1


@pytest.mark.parametrize("batch,K,L,Dm,N,T", [CASES[1], CASES[3]],
                         ids=[IDS[1], IDS[3]])
def test_twins_in_bf16_match_plain(batch, K, L, Dm, N, T):
    """bf16 operands: the twins against the plain versions on the same bf16
    values (y rounded to bf16 on both sides; the gradients fp32)."""
    inp, dy, _ = _inputs(3 * L + T, batch, K, L, Dm, N)
    args = [torch.from_numpy(inp[k]) for k in NAMES]
    for i in (0, 1, 3, 4):                       # u, delta, B, C
        args[i] = args[i].bfloat16()
    dyt = torch.from_numpy(dy).bfloat16()
    y_w, x_w = v1.scan_v1_fwd_walk_ref(*args, T)
    y_p, x_p = v1.scan_v1_fwd_ref(*args, T)
    assert y_w.dtype == torch.bfloat16
    _close(y_w, y_p, "y", 3e-2, 5e-2)
    _close(x_w, x_p, "xsave", 3e-2, 5e-2)
    for name, gw, gp in zip(GRADS, v1.scan_v1_bwd_pieces_ref(
            *args, x_p, dyt, T), v1.scan_v1_bwd_ref(*args, x_p, dyt, T)):
        _close(gw, gp, name, 3e-2, 5e-2)


def _constants(path):
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr (?:int|size_t) (k\w+) = (\d+);", path.read_text())}


def test_twins_constants_are_the_kernels():
    """The twins' piece, window, cluster and states a thread are the CUDA
    sources'; the backward's grid, the number of dB/dC sums it writes and
    its checkpoint scratch."""
    bwd = _constants(CSRC / "selective_scan_v1_bwd.cu")
    fwd = _constants(CSRC / "selective_scan_v1_fwd.cu")
    assert (bwd["kPiece"], bwd["kWinCap"], bwd["kMaxCluster"],
            bwd["kStates"], fwd["kStates"]) == (
        v1.PIECE, v1.WIN_CAP, v1.CLUSTER, v1.STATES, v1.STATES)
    # blocks of 96 channels (12 warps) at N <= 16, 32 channels above; the
    # bench's stages: one block a sequence at Dm 96, then clusters of 2, 4
    # and 8 blocks, each sequence's dB and dC written once
    assert [v1.bwd_grid(Dm, 16) for Dm in (96, 192, 384, 768)] == [
        (1, 1, 384), (2, 1, 384), (4, 1, 384), (8, 1, 384)]
    assert v1.bwd_grid(36, 64) == (2, 1, 512)
    assert v1.bwd_grid(1000, 16) == (12, 2, 384)   # 11 blocks in 2 of 6
    # at most ceil(Dm / 256) sums a sequence, where the first port wrote
    # ceil(Dm / 8) partials
    for N in (4, 16, 32, 64):
        for Dm in range(1, 2000):
            assert v1.bwd_clusters(Dm, N) <= -(-Dm // 256), (Dm, N)
    assert v1.bwd_ckpt_floats(128, 96, 16, 50) == 128 * 7 * 384 * 4


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_v1_bounds(monkeypatch):
    """At the bench's stage 0 in bf16 (G 128, L 3136, Dm 96, N 16, T 50)
    row 3's bound is the function's 617 M exps at the MUFU rate, 0.1474
    ms, above its 306 MB of bytes (0.0915 ms); row 4's stays its 665 MB of
    bytes, 0.1988 ms."""
    cs = _chip_smoke(monkeypatch)
    exps = 128 * 3136 * 96 * 16
    fwd = cs._v1_bound(3136, 96, 50, "bf16", False)
    bwd = cs._v1_bound(3136, 96, 50, "bf16", True)
    assert fwd == (pytest.approx(exps / cs.MUFU_PER_S * 1e3), "operations")
    assert fwd[0] == pytest.approx(0.1474, abs=1e-4)
    assert bwd[1] == "bytes" and bwd[0] == pytest.approx(0.1988, abs=1e-4)


def _globals(path):
    """The names of the __global__ functions a CUDA source defines."""
    text = path.read_text()
    names = set()
    for m in re.finditer(r"__global__\s+void\s+", text):
        i = m.end()
        if text.startswith("__launch_bounds__", i):   # skip (balanced)
            depth, i = 0, text.index("(", i)
            while True:
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                i += 1
                if depth == 0:
                    break
        names.add(re.match(r"\s*(\w+)\s*\(", text[i:]).group(1))
    return names


def test_chip_smoke_v1_split_names_are_kernels(monkeypatch):
    """The names chip_smoke's 2o and 2p look for in a profile are the
    __global__ kernels of the two v1 sources: a stale name would print an
    empty split."""
    cs = _chip_smoke(monkeypatch)
    for split, src in ((cs.V1_FWD_SPLIT, "selective_scan_v1_fwd.cu"),
                       (cs.V1_BWD_SPLIT, "selective_scan_v1_bwd.cu")):
        kernels = _globals(CSRC / src)
        assert set(split.values()) == kernels, (src, kernels)
