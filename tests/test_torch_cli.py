"""The port's eval CLI on a tiny ImageFolder, its import hygiene (no JAX),
the scan wrapper's refusals on the CPU, and chip_smoke.py's refusal to run
without a CUDA device."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import medical_image_classification_tpu_torch.models.registry as registry
from medical_image_classification_tpu_torch.cli.test import main, parse_args
from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    _check_cuda_args,
    scan_folded_fwd,
)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_dataset(root, n=3, size=32):
    import cv2
    rng = np.random.RandomState(0)
    for cls in ("a", "b"):
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            cv2.imwrite(os.path.join(d, f"{i}.png"),
                        rng.randint(0, 256, (size, size, 3), np.uint8))


def test_eval_cli_on_image_folder(tmp_path, monkeypatch, caplog):
    root = str(tmp_path / "data")
    _make_dataset(root)
    orig = registry._REGISTRY["medmamba"]

    def tiny(num_classes, **kw):
        kw.update(depths=(1, 1), dims=(16, 32), d_state=4,
                  drop_path_rate=0.0)
        return orig(num_classes, **kw)

    monkeypatch.setitem(registry._REGISTRY, "medmamba", tiny)
    weights = str(tmp_path / "m.pt")
    torch.save(tiny(2, generator=torch.Generator().manual_seed(1))
               .state_dict(), weights)
    args = parse_args(["--data-path", root, "--num-classes", "2",
                       "--weights", weights, "--batch-size", "4",
                       "--image-size", "32", "--device", "cpu"])
    with caplog.at_level(logging.INFO, logger="mic_torch"):
        acc = main(args)
    assert 0.0 <= acc <= 1.0
    assert "test top-1 accuracy" in caplog.text and "(6 images)" in caplog.text


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import medical_image_classification_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'medical_image_classification_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'medical_image_classification_tpu_torch.cli.test' in "
        "sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _cpu_scan_args(G=2, L=8, Dm=32, N=4, K=1):
    f = lambda *s: torch.randn(*s)
    return [f(G, L, Dm), f(G, L, Dm), -torch.rand(K, Dm, N), f(G, L, N),
            f(G, L, N), f(K, Dm), f(K, Dm)]


def test_scan_cuda_impl_on_cpu_raises():
    before = scan_folded_fwd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan_folded_fwd(*_cpu_scan_args(), impl="cuda")
    with pytest.raises(ValueError, match="unknown scan impl"):
        scan_folded_fwd(*_cpu_scan_args(), impl="pallas")
    assert scan_folded_fwd.launches == before


@pytest.mark.parametrize("fault", ["noncontiguous", "dtype", "mixed_dtype",
                                   "large_n", "shape"])
def test_kernel_wrapper_refuses_bad_input(fault):
    """The argument checks that run before any launch."""
    args = _cpu_scan_args()
    if fault == "noncontiguous":
        args[0] = torch.randn(2, 32, 8).transpose(1, 2)
    elif fault == "dtype":
        args[0], args[1], args[3], args[4] = (
            a.half() for a in (args[0], args[1], args[3], args[4]))
    elif fault == "mixed_dtype":
        args[3] = args[3].bfloat16()
    elif fault == "large_n":
        args = _cpu_scan_args(N=65)
    else:
        args[5] = torch.randn(1, 31)
    with pytest.raises((ValueError, TypeError)):
        _check_cuda_args(*args)


def test_kernel_wrapper_accepts_good_input():
    for dtype in (torch.float32, torch.bfloat16):
        args = _cpu_scan_args(N=64)
        for i in (0, 1, 3, 4):
            args[i] = args[i].to(dtype)
        _check_cuda_args(*args)


def test_chip_smoke_refuses_without_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
