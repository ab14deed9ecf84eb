"""The port's selective-scan kernel bench against the JAX script.

The plain calibration floor (``kernels/scan_calib.py``) against a numpy
restatement of the JAX script's kernel body ``kern`` in fp32 and with its
bf16 rounding, and against ``kern`` itself: the JAX script's
``calib_kernel_bench`` runs at a small stage with ``pl.pallas_call`` in
interpret mode and its timing harness captured, and the array ``run``
returns (pad rows included) is compared.  Then ``make_inputs`` bit for bit,
the argument parser against the JAX script's flags, ``main`` refusing to
run without a card, and the port's bench importing nothing of JAX."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_classification_tpu_torch.kernels import (
    scan_calib as calib,
    selective_scan_fwd as fwd,
    selective_scan_v1 as v1,
)
from medical_image_classification_tpu_torch.scripts import kernel_bench as kb

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(G=8, L=49, Dm=32, N=4)       # T 56 from the tile chooser: pads


@pytest.fixture
def jax_bench(monkeypatch):
    """The JAX script ``scripts/kernel_bench.py`` as a module (its import
    sets a default compilation-cache directory in the environment, which
    is put back)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_bench", ROOT / "scripts" / "kernel_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(x):
    """Round float32 to bf16 (nearest, ties to even) and back, in numpy."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def _kern_numpy(u, delta, At, B, C, T, bf16):
    """``kern`` (scripts/kernel_bench.py:134-145) restated in numpy over the
    padded rows: cast to cdt, softplus, exp and each product rounded to cdt,
    the product cast to fp32 and summed over n."""
    rd = _bf16 if bf16 else (lambda x: np.asarray(x, np.float32))
    G, L, Dm = u.shape
    K, N, _ = At.shape
    pad = ((0, 0), (0, (-L) % T), (0, 0))
    uf, dv, Bv, Cv = (rd(np.pad(t, pad)) for t in (u, delta, B, C))
    dt = rd(np.logaddexp(dv, np.float32(0)))
    Av = rd(At)[np.arange(G) % K]                       # [G, N, Dm]
    a = rd(np.exp(rd(dt[:, :, None, :] * Av[:, None])))
    b = rd(rd(dt * uf)[:, :, None, :] * Bv[..., None])
    return rd(Cv[..., None] * rd(a * b)).astype(np.float32).sum(axis=2)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_calibration_matches_kern_restated(bf16):
    """The plain calibration against the numpy restatement at a padding
    shape: fp32 compute with fp32 operands at 1e-5 (the sum order is the
    same), bf16 compute (bf16 operands and output) at 3e-2 / 2e-2 x
    max|y|: exp and softplus may land one bf16 step apart."""
    rng = np.random.default_rng(11)
    G, L, Dm, N, K, T = 8, 49, 32, 4, 4, 56
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, delta, B, C = f(G, L, Dm), 0.1 * f(G, L, Dm), f(G, L, N), f(G, L, N)
    At = -np.abs(f(K, N, Dm)) - 0.5
    dt = torch.bfloat16 if bf16 else torch.float32
    args = [torch.from_numpy(a).to(dt) for a in (u, delta)] + [
        torch.from_numpy(At)] + [torch.from_numpy(a).to(dt) for a in (B, C)]
    y = calib.scan_calib(*args, T, bf16_compute=bf16)
    assert y.shape == (G, 56, Dm) and y.dtype == dt
    assert not bool(y[:, L:].any())                 # the pad rows are 0
    ops = [a.float().numpy() for a in args]
    want = _kern_numpy(*ops, T, bf16)
    if bf16:
        want = _bf16(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(y.float().numpy(), want, rtol=3e-2,
                                   atol=2e-2 * scale)
    else:
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_calibration_matches_the_jax_kernel(monkeypatch, jax_bench,
                                                  bf16):
    """The JAX script's ``calib_kernel_bench`` at a small stage (G 8, L 49,
    Dm 32, N 4: T 56, so L pads), its Pallas kernel in interpret mode and
    its timing harness replaced by one that keeps the jitted function: run
    eagerly, ``run`` returns y [G, 56, Dm] bf16, which the port's plain
    calibration on the port's ``make_inputs`` matches within 3e-2 / 2e-2 x
    max|y| (y is bf16 on both sides: one bf16 step apart where a sum
    straddles a rounding point), and so do the sums."""
    from jax.experimental import pallas as pl
    if bf16:
        monkeypatch.setenv("CALIB_BF16", "1")
    else:
        monkeypatch.delenv("CALIB_BF16", raising=False)
    pallas_call, got = pl.pallas_call, {}

    def interpreted(*a, **k):
        f = pallas_call(*a, **dict(k, interpret=True))

        def run(*args):
            got["y"] = f(*args)
            return got["y"]
        return run

    def harness(name, fn, args, iters):       # the JAX script's signature
        got["fn"], got["args"] = fn, args
        return 0.0
    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jax_bench, "bench_impl", harness)
    jax_bench.calib_kernel_bench(SMALL, 1)
    total = float(got["fn"].__wrapped__(*got["args"]))
    y_j = np.asarray(got["y"], np.float32)

    T, _ = v1._choose_tiles(SMALL["L"], SMALL["Dm"], SMALL["N"])
    u, delta, A, B, C, _, _ = kb.make_inputs(**SMALL)
    y_t = calib.scan_calib(u, delta, A.transpose(1, 2).contiguous(), B, C,
                           T, bf16_compute=bf16)
    assert y_t.shape == y_j.shape == (8, 56, 32)
    scale = float(np.abs(y_j).max())
    np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=3e-2,
                               atol=2e-2 * scale)
    np.testing.assert_allclose(float(y_t.float().sum()), total, rtol=1e-2,
                               atol=1e-2 * scale)


def test_make_inputs_bit_for_bit(jax_bench):
    """The port's inputs equal the JAX script's at a small stage, every
    bit: activations in bf16 (through float32, as JAX converts),
    parameters in fp32."""
    cfg = dict(G=8, L=20, Dm=16, N=4)
    for name, j, t in zip(("u", "delta", "A", "B", "C", "D", "bias"),
                          jax_bench.make_inputs(**cfg), kb.make_inputs(**cfg)):
        assert str(j.dtype) == str(t.dtype).replace("torch.", ""), name
        assert tuple(j.shape) == tuple(t.shape), name
        np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                      t.float().numpy(), err_msg=name)


def test_parser_takes_the_jax_flags(monkeypatch, jax_bench):
    """The port's parser has the JAX script's options with their defaults
    (the JAX parser is caught as its ``main`` parses; ``--impl``'s default
    names the same dispatch, "pallas" there, "cuda" here), and takes a JAX
    command line; ``--impl`` names nothing but that dispatch."""
    import argparse

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught) as info:
            jax_bench.main()
    opts = lambda p: {a.dest: (tuple(a.option_strings), a.default, a.type)
                      for a in p._actions}
    want, got = opts(info.value.args[0]), opts(kb.parser())
    assert set(want) == set(got)
    for dest in want:
        if dest == "impl":
            kb._check_impl(want[dest][1])
            assert want[dest][0] == got[dest][0]
        else:
            assert want[dest] == got[dest], dest
    args = kb.parser().parse_args(
        ["--stage", "all", "--iters", "3", "--impl", "pallas", "--t-cap",
         "50", "--vmem-budget-mb", "16", "--calibrate"])
    assert (args.stage, args.iters, args.t_cap, args.vmem_budget_mb,
            args.calibrate) == ("all", 3, 50, 16, True)
    kb._check_impl(args.impl)
    kb._check_impl("cuda,pallas")
    for bad in ("torch", "xla"):
        with pytest.raises(ValueError):
            kb._check_impl(bad)


def test_main_needs_a_card(monkeypatch, capsys):
    """Without a CUDA device ``main`` raises before it sets the cap or
    prints a line, and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (fwd.scan_folded_fwd.launches, v1.scan_v1_fwd.launches,
              calib.scan_calib.launches)
    for argv in (["--stage", "3", "--iters", "1", "--t-cap", "50"],
                 ["--calibrate", "--stage", "3"]):
        with pytest.raises(RuntimeError, match="CUDA device"):
            kb.main(argv)
    assert v1._T_CAP == 224 and capsys.readouterr().out == ""
    assert before == (fwd.scan_folded_fwd.launches, v1.scan_v1_fwd.launches,
                      calib.scan_calib.launches)


def test_bench_imports_nothing_of_jax():
    """A fresh interpreter that imports the port's bench (and its kernel
    modules) has imported no jax and nothing of the JAX package."""
    code = ("import sys, medical_image_classification_tpu_torch.scripts"
            ".kernel_bench\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'optax')) or m.split('.')[0] == "
            "'medical_image_classification_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("shape", [
    dict(G=8, L=49, Dm=32, N=4, T=56),      # the padding shape
    dict(G=8, L=30, Dm=15, N=24, T=16),     # odd Dm, N past 16, ragged L
], ids=["pad", "ragged"])
def test_factored_twin_matches_ref_and_kern(shape):
    """``scan_calib_factored_ref`` (the CUDA kernel's fp32 order: dt u out
    of the sum, B C once, exp2 of dt A log2 e) against ``scan_calib_ref``
    and the numpy restatement of ``kern`` in fp32 at 1e-5, the pad rows 0:
    the same function, its roundings in another order."""
    rng = np.random.default_rng(17)
    G, L, Dm, N, T = (shape[k] for k in ("G", "L", "Dm", "N", "T"))
    K = 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, delta, B, C = f(G, L, Dm), 0.1 * f(G, L, Dm), f(G, L, N), f(G, L, N)
    At = -np.abs(f(K, N, Dm)) - 0.5
    args = [torch.from_numpy(a) for a in (u, delta, At, B, C)]
    y = calib.scan_calib_factored_ref(*args, T)
    Lp = -(-L // T) * T
    assert y.shape == (G, Lp, Dm) and y.dtype == torch.float32
    assert not bool(y[:, L:].any())
    np.testing.assert_allclose(y.numpy(), calib.scan_calib_ref(*args, T),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), _kern_numpy(u, delta, At, B, C, T,
                                                      False),
                               rtol=1e-5, atol=1e-5)
    # in bf16 operands the output keeps u's type
    ub, db, Bb, Cb = (args[i].bfloat16() for i in (0, 1, 3, 4))
    yb = calib.scan_calib_factored_ref(ub, db, args[2], Bb, Cb, T)
    assert yb.dtype == torch.bfloat16 and yb.shape == (G, Lp, Dm)


def test_calibration_wrapper_checks_before_launching():
    """The CUDA route refuses CPU tensors, and the wrapper's checks raise
    before any launch for every size the C entry refuses below 1 (G, L,
    Dm, K, N) and for a chunk below 1; no size above 1 is refused (odd Dm
    and any N run on the card)."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    u, delta, At, B, C = f(4, 9, 5), f(4, 9, 5), f(2, 3, 5), f(4, 9, 3), \
        f(4, 9, 3)
    before = calib.scan_calib.launches
    with pytest.raises(ValueError, match="impl='cuda'"):
        calib.scan_calib(u, delta, At, B, C, 4, impl="cuda")
    with pytest.raises(ValueError, match="chunk T"):
        calib._launch_cuda(u, delta, At, B, C, 0, False)
    for name, bad in (
            ("G", (u[:0], delta[:0], At, B[:0], C[:0])),
            ("L", (u[:, :0], delta[:, :0], At, B[:, :0], C[:, :0])),
            ("Dm", (u[..., :0], delta[..., :0], At[..., :0], B, C)),
            ("K", (u, delta, At[:0], B, C)),
            ("N", (u, delta, At[:, :0], B[..., :0], C[..., :0]))):
        bad = [t.contiguous() for t in bad]
        with pytest.raises(ValueError, match=f"{name}=0"):
            calib._launch_cuda(*bad, 4, False)
    assert calib.scan_calib.launches == before


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("stage,mufu_ms", [("0", 0.1474), ("1", 0.0737),
                                           ("2", 0.0369), ("3", 0.0184)])
def test_chip_smoke_calib_bound(monkeypatch, stage, mufu_ms):
    """At each of the bench's stages (bf16, T from the tile chooser) the
    calibration's bound is its exps at the MUFU rate, above its bytes and
    its CUDA-core operations; at stage 0 617 M exps, 0.1474 ms, over 256.9
    MB of bytes (0.0767 ms)."""
    cs = _chip_smoke(monkeypatch)
    cfg = kb.STAGES[stage]
    T, _ = v1._choose_tiles(cfg["L"], cfg["Dm"], cfg["N"])
    exps = cfg["G"] * cfg["L"] * cfg["Dm"] * cfg["N"]
    got = cs._calib_bound(cfg, T, "bf16")
    assert got == (pytest.approx(exps / cs.MUFU_PER_S * 1e3), "operations")
    assert got[0] == pytest.approx(mufu_ms, abs=1e-4)
    if stage == "0":
        assert exps == 616_562_688 and T == 224
        nbytes = 128 * 3136 * (2 * 96 + 2 * 16) * 2 + 128 * 3136 * 96 * 2 \
            + 4 * 16 * 96 * 4
        assert nbytes == 256_925_696
        assert cs._bound(nbytes, 5 * exps, "fp32") == (
            pytest.approx(0.0767, abs=1e-4), "bytes")
        # fp32 operands move twice the bytes: 0.1534 ms, above the MUFU
        assert cs._calib_bound(cfg, T, "fp32") == (
            pytest.approx(2 * (nbytes - 4 * 16 * 96 * 4) / cs.HBM_BPS * 1e3
                          + 4 * 16 * 96 * 4 / cs.HBM_BPS * 1e3), "bytes")


def test_chip_smoke_calib_cases_reach_the_tails(monkeypatch):
    """Phase 2q's ragged cases run the kernel's edges: each an odd Dm (a
    half pair), L not a multiple of the chooser's T (pad rows), G a
    multiple of the bench's K 4; one N past the 16 states the kernel keeps
    in registers, one N below it (zero-padded states); and the profile name
    of its one pass is a ``__global__`` of the source."""
    cs = _chip_smoke(monkeypatch)
    src = (ROOT / "medical_image_classification_tpu_torch" / "csrc"
           / "scan_calib.cu").read_text()
    assert "constexpr int kRegN = 16;" in src
    for r in cs.CALIB_RAGGED:
        T, _ = v1._choose_tiles(r["L"], r["Dm"], r["N"])
        assert r["Dm"] % 2 == 1 and r["L"] % T and r["G"] % 4 == 0
    assert sorted(r["N"] > 16 for r in cs.CALIB_RAGGED) == [False, True]
    assert all(r["N"] % 4 for r in cs.CALIB_RAGGED if r["N"] < 16)
    for pattern in cs.CALIB_SPLIT.values():
        assert f"{pattern}(const T* __restrict__ u" in src
