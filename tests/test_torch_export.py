"""The kernels as ``torch.library`` custom ops and ``cli/export.py`` on the
CPU.  ``torch.library.opcheck`` for each of the six forward ops and the six
backward ops (schema, fake tensors, aot dispatch) at small shapes, each
op's output the plain version's bit for bit; reduced medmamba and st_ssd
exported through ``torch.export``, saved, loaded and run: the program holds the
``mic_torch`` ops, its logits equal the eager forward's (rtol 1e-5, as
``tests/test_cli_train.py::test_export_roundtrip``), and a fresh
interpreter that imports only ``kernels/ops.py`` loads and runs it (and
cannot load it without); ``cli/export.py --load`` on the file."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd
import medical_image_classification_tpu_torch.kernels.stf_zgate as tszp
import medical_image_classification_tpu_torch.kernels.stl_mixer as tsmp
from medical_image_classification_tpu_torch.cli import export
from medical_image_classification_tpu_torch.kernels import (
    ops,
    selective_scan_bwd as ssb,
    selective_scan_fwd as ssf,
    ssd_fused as sf,
    ssd_fused_dirs as sfd,
)
from medical_image_classification_tpu_torch.models import registry

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan_args(rng, init):
    G, L, Dm, K, N = 4, 37, 8, 2, 4
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    A = -torch.from_numpy(rng.random((K, Dm, N)).astype(np.float32) + 0.1)
    return (f(G, L, Dm), 0.5 * f(G, L, Dm), A, f(G, L, N), f(G, L, N),
            f(K, Dm), 0.1 * f(K, Dm), f(G, N, Dm) if init else None)


def _cases():
    """(op, args without impl, the plain version's outputs)."""
    from test_torch_ssd_dirs import _inputs as dirs_inputs, _torch
    from test_torch_ssd_fused import _cast, _inputs as fused_inputs
    from test_torch_st_kernels import _ydiag_args, _stl_args, _stf_args
    rng = np.random.default_rng(0)
    t = lambda args: tuple(torch.from_numpy(a) for a in args)
    cases = []
    for init, reverse, xsave, state in ((False, False, False, False),
                                        (True, True, True, True)):
        a = _scan_args(rng, init)
        cases.append((ops.selective_scan_fwd,
                      a + (reverse, True, xsave, state),
                      ssf.scan_folded_fwd_ref(
                          *a[:7], reverse=reverse, want_xsave=xsave,
                          want_state=state, init=a[7])))
    for dt in (torch.float32, torch.bfloat16):
        args, _, d_ssm, gn = dirs_inputs(B=1, seed=4)
        a = _torch(args, dt) + (d_ssm, gn, True)
        cases.append((ops.ssd_fused_dirs_fwd, a,
                      sfd.ssd_fused_dirs_fwd_ref(*a)))
        args, _ = fused_inputs(B=1, seed=4)
        a = _cast(args, tdt=dt) + (True,)
        cases.append((ops.ssd_fused_fwd, a, sf.ssd_fused_fwd_ref(*a)))
    a = t(_ydiag_args(rng, 3, 24, 2, 8, 64)[0])
    cases.append((ops.ssd_ydiag_fwd, a, tyd.ydiag_fused_ref(*a)))
    a = t(_stl_args(rng, 2, 24, 16, 128)[0])
    cases.append((ops.stl_mixer_fwd, a, tsmp.stl_mixer_fwd_ref(*a, True)))
    a = t(_stf_args(rng, 2, 16, 128)[0])
    cases.append((ops.stf_zgate_fwd, a, tszp.stf_zgate_fwd_ref(*a)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]._name}-{i}"
                              for i, c in enumerate(CASES)])
def test_op_passes_opcheck_and_equals_the_plain_version(i):
    op, args, want = CASES[i]
    args = args + ("torch",)
    torch.library.opcheck(op, args)
    got = op(*args)
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _bwd_cases():
    """(backward op, args without impl, the plain backward's cotangents in
    their primals' dtypes), each at the forward cases' shapes, fp32 and
    bf16 where the forward has both."""
    from test_torch_ssd_dirs import _inputs as dirs_inputs, _torch
    from test_torch_ssd_fused import _cast, _inputs as fused_inputs
    from test_torch_st_kernels import _ydiag_args, _stl_args, _stf_args
    rng = np.random.default_rng(1)
    t = lambda args: tuple(torch.from_numpy(a) for a in args)
    like = lambda ref: torch.from_numpy(
        rng.standard_normal(ref.shape).astype(np.float32)).to(ref.dtype)
    cast = lambda grads, prim: [g.to(p.dtype) for g, p in zip(grads, prim)]
    cases = []
    for init, reverse in ((False, False), (True, True)):
        a = _scan_args(rng, init)
        y, xsave, last = ssf.scan_folded_fwd_ref(
            *a[:7], reverse=reverse, want_xsave=True, want_state=True,
            init=a[7])
        dy, dlast = like(y), like(last) if init else None
        want = ssb.scan_folded_bwd_ref(*a[:7], xsave, dy, reverse=reverse,
                                       softplus=True, dlast=dlast,
                                       want_dinit=init)
        cases.append((ops.selective_scan_bwd,
                      a[:7] + (xsave, dy, dlast, reverse, True, init),
                      cast(want, a[:7]) + list(want[7:])))
    for dt in (torch.float32, torch.bfloat16):
        args, _, d_ssm, gn = dirs_inputs(B=1, seed=5)
        a = _torch(args, dt)
        y, Ssave = sfd.ssd_fused_dirs_fwd_ref(*a, d_ssm, gn, True)
        b = a + (d_ssm, gn, Ssave, like(y))
        cases.append((ops.ssd_fused_dirs_bwd, b,
                      cast(sfd.ssd_fused_dirs_bwd_ref(*b), a)))
        args, _ = fused_inputs(B=1, seed=5)
        a = _cast(args, tdt=dt)
        y, Ssave = sf.ssd_fused_fwd_ref(*a, True)
        b = a + (Ssave, like(y))
        cases.append((ops.ssd_fused_bwd, b, cast(sf.ssd_fused_bwd_ref(*b),
                                                 a)))
    a = t(_ydiag_args(rng, 3, 24, 2, 8, 64)[0])
    b = a + (like(tyd.ydiag_fused_ref(*a)),)
    cases.append((ops.ssd_ydiag_bwd, b, cast(tyd.ydiag_fused_bwd_ref(*b), a)))
    a = t(_stl_args(rng, 2, 24, 16, 128)[0])
    U, lse = tsmp.stl_mixer_fwd_ref(*a, True)
    b = a + (like(U), lse)
    cases.append((ops.stl_mixer_bwd, b, cast(tsmp.stl_mixer_bwd_ref(*b), a)))
    a = t(_stf_args(rng, 2, 16, 128)[0])
    b = a + (like(tszp.stf_zgate_fwd_ref(*a)),)
    cases.append((ops.stf_zgate_bwd, b, cast(tszp.stf_zgate_bwd_ref(*b), a)))
    return cases


BWD_CASES = _bwd_cases()


@pytest.mark.parametrize("i", range(len(BWD_CASES)),
                         ids=[f"{c[0]._name}-{i}"
                              for i, c in enumerate(BWD_CASES)])
def test_backward_op_passes_opcheck_and_equals_the_plain_version(i):
    """Each backward op: opcheck (its fake's shapes and dtypes against the
    body's), and its cotangents the plain backward's bit for bit, each in
    its primal's dtype."""
    op, args, want = BWD_CASES[i]
    args = args + ("torch",)
    torch.library.opcheck(op, args)
    got = op(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_six_ops_one_per_forward_kernel():
    assert sorted(op._qualname for op in ops.OPS) == sorted(
        f"mic_torch::{k}" for k in (
            "selective_scan_fwd", "ssd_fused_dirs_fwd", "ssd_fused_fwd",
            "ssd_ydiag_fwd", "stl_mixer_fwd", "stf_zgate_fwd"))
    assert [op._qualname for op in ops.BWD_OPS] == [
        op._qualname[:-len("fwd")] + "bwd" for op in ops.OPS]


TINY = {
    "medmamba": dict(depths=(1, 1), dims=(16, 32), d_state=4,
                     drop_path_rate=0.0),
    "st_ssd": dict(depths=(1, 1), dims=(128, 256), d_state=16,
                   ssd_headdim=32, st_tokens=(8, 4), drop_path_rate=0.0),
}
# the mic_torch calls of one forward of each: the scan four times a block;
# in st_ssd's block of each stage Y_diag (one chunk, l 64 and 16), the
# mixer and the gate
OP_CALLS = {
    "medmamba": {"mic_torch::selective_scan_fwd": 8},
    "st_ssd": {"mic_torch::ssd_ydiag_fwd": 2, "mic_torch::stl_mixer_fwd": 2,
               "mic_torch::stf_zgate_fwd": 2},
}


@pytest.fixture
def tiny(monkeypatch):
    """The registry's medmamba and st_ssd shrunk, st_ssd's kernel gates
    widened to its shapes (as ``tests/test_torch_st_ssd.py`` does)."""
    for name, kw in TINY.items():
        orig = registry._REGISTRY[name]
        monkeypatch.setitem(registry._REGISTRY, name,
                            lambda num_classes, orig=orig, kw=kw, **k:
                            orig(num_classes, **{**k, **kw}))
    monkeypatch.setattr(tyd, "_MIN_L", 8)
    monkeypatch.setattr(tsmp, "_MIN_LP", 8 * 8)
    monkeypatch.setattr(tszp, "_MIN_PP", 8 * 8)


@pytest.mark.parametrize("name", ["medmamba", "st_ssd"])
def test_export_save_load_matches_eager(tmp_path, tiny, name, capsys):
    weights, out = str(tmp_path / "w.pt"), str(tmp_path / f"{name}.pt2")
    model = registry.create_model(
        name, 8, generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), weights)
    program, stats = export.main(export.parse_args(
        ["--model", name, "--weights", weights, "--batch-size", "2",
         "--image-size", "32", "--dtype", "fp32", "--out", out,
         "--device", "cpu"]))
    assert export.op_calls(program) == OP_CALLS[name]
    assert stats["bytes"] == os.path.getsize(out) > 0
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    serve, _ = export.build_serve_module(name, 8, weights, 2, 32, None,
                                         torch.device("cpu"))
    with torch.no_grad():
        want = serve(x)
        got = torch.export.load(out).module()(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    loaded = export.main(export.parse_args(["--load", out]))
    torch.testing.assert_close(loaded, want, rtol=1e-5, atol=1e-6)
    assert f"loaded {out}: (2, 32, 32, 3) torch.uint8 -> (2, 8) " \
        "torch.float32" in capsys.readouterr().out

    if name == "medmamba":
        _load_in_a_fresh_interpreter(out, want.numpy(), tmp_path)


def _load_in_a_fresh_interpreter(path, want, tmp_path):
    """The program does not load without the ops; with only kernels/ops.py
    imported it loads and runs, importing nothing of the models."""
    np.save(str(tmp_path / "want.npy"), want)
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        f"path = {path!r}\n"
        "try:\n"
        "    torch.export.load(path)\n"
        "    refused = False\n"
        "except Exception:\n"
        "    refused = True\n"
        "from medical_image_classification_tpu_torch.kernels import ops\n"
        "x = torch.from_numpy(np.random.RandomState(0).randint(\n"
        "    0, 256, (2, 32, 32, 3), dtype=np.uint8))\n"
        "with torch.no_grad():\n"
        "    out = torch.export.load(path).module()(x)\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        "pkg = 'medical_image_classification_tpu_torch.'\n"
        "mods = sorted(m[len(pkg):] for m in sys.modules\n"
        "              if m.startswith(pkg))\n"
        "print(json.dumps(dict(refused=refused, mods=mods,\n"
        "    err=float(np.abs(out.numpy() - want).max()))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["refused"] and r["err"] <= 1e-5 * float(np.abs(want).max())
    assert all(m.startswith("kernels") for m in r["mods"]), r["mods"]


def test_host_cost_script_needs_a_card(monkeypatch):
    """scripts/host_cost.py raises without a CUDA device, before any
    build."""
    from medical_image_classification_tpu_torch.scripts import host_cost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        host_cost.main([])
