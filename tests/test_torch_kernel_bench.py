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
