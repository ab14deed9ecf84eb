"""The port's CLIs on a tiny ImageFolder, its copy of the ImageFolder
pipeline against the JAX package's, its import hygiene (no JAX on the eval
or the train path, the CLIs' ``main()`` included), the scan wrapper's
refusals on the CPU, and chip_smoke.py's refusal to run without a CUDA
device."""

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


@pytest.mark.parametrize("cli", ["test", "train", "test_all_index", "cam",
                                 "export", "ddp_train",
                                 "scripts.profile_step",
                                 "scripts.profile_fusion_step",
                                 "scripts.trace_ops", "scripts.flops_report"])
def test_clis_default_to_the_card_and_raise_without_one(monkeypatch,
                                                        tmp_path, cli):
    """The CLIs (and the profiling and FLOP scripts) run on the card unless
    asked for the CPU (--device cuda by default), and without a card their
    main() raises before it reads the data (the image, the weights, the
    capture): nothing falls back to the CPU."""
    import importlib
    mod = importlib.import_module("medical_image_classification_tpu_torch."
                                  + (cli if "." in cli else f"cli.{cli}"))
    missing = str(tmp_path / "missing")
    argv = {"cam": ["--image", missing, "--weights", missing],
            "export": ["--weights", missing],
            "scripts.profile_step": [], "scripts.profile_fusion_step": [],
            "scripts.trace_ops": [missing], "scripts.flops_report": []}
    args = mod.parse_args(argv.get(cli, ["--data-path", missing]))
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)


def test_port_imports_no_jax():
    """Every module of the port imports (the parallel/ modules and
    cli/ddp_train among them, the profiling and FLOP modules and their
    scripts), and a train epoch and an eval pass through run_train and
    run_eval run, an eval pass traced and summarised and a forward's FLOPs
    counted, without jax, flax, optax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch\n"
        "import medical_image_classification_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from medical_image_classification_tpu_torch.cli.test import "
        "run_eval\n"
        "from medical_image_classification_tpu_torch.cli.train import "
        "run_train\n"
        "from medical_image_classification_tpu_torch.data.loader import "
        "SyntheticLoader\n"
        "from medical_image_classification_tpu_torch.models import "
        "create_model\n"
        "from medical_image_classification_tpu_torch.train.optim import "
        "make_lr_scheduler, make_optimizer, make_schedule\n"
        "model = create_model('medmamba', 2, depths=(1, 1), dims=(16, 32), "
        "d_state=4)\n"
        "opt = make_optimizer('adam', model.named_parameters())\n"
        "sched = make_lr_scheduler(opt, make_schedule('constant', 1e-3))\n"
        "loader = SyntheticLoader(2, 32, 2, steps=2)\n"
        "m = run_train(model, opt, sched, loader, torch.device('cpu'))\n"
        "assert m['steps'] == 2 and m['loss'] == m['loss'], m\n"
        "run_eval(model, loader, torch.device('cpu'))\n"
        "import tempfile\n"
        "from medical_image_classification_tpu_torch.utils import flops, "
        "profiling\n"
        "d = tempfile.mkdtemp()\n"
        "with profiling.trace(d):\n"
        "    run_eval(model, loader, torch.device('cpu'))\n"
        "s = profiling.summarize_trace(d)\n"
        "assert s['total_ms'] > 0 and '?' not in s['by_source'], s\n"
        "assert flops.model_flops(model, torch.zeros(2, 32, 32, 3)) > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'medical_image_classification_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('cli.test', 'cli.train', 'cli.ddp_train', 'parallel.mesh',"
        " 'parallel.collectives', 'parallel.sequence_parallel',"
        " 'utils.profiling', 'utils.flops', 'scripts.profile_step',"
        " 'scripts.profile_fusion_step', 'scripts.trace_ops',"
        " 'scripts.flops_report'):\n"
        "    assert 'medical_image_classification_tpu_torch.' + m in "
        "sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("model,tiny", [
    ("medmamba", "depths=(1, 1), dims=(16, 32), d_state=4"),
    ("medssd", "depths=(1, 1), dims=(32, 64), d_state=8, ssd_headdim=8"),
    ("st_ssd", "depths=(1, 1), dims=(32, 64), d_state=8, ssd_headdim=8, "
               "st_tokens=(4, 2)"),
    ("cnn_mamba_mifa", "depths=(1, 1), dims=(32, 64), ssd_headdim=8"),
    ("kanin_ssd", "depths=(1, 1), dims=(32, 64), ssd_headdim=8"),
    ("vfefm_2b2", "--depths 1,1 --dims 8,16 --headdim 4 --d-state 4 "
                  "--image-size 16")])
def test_cli_mains_on_image_folder_import_no_jax(tmp_path, model, tiny):
    """cli.train.main (one epoch, then its val pass), cli.test.main (top-1
    and --all-index), cli.test_all_index.main, cli.cam.main (one image)
    and cli.export.main (export, then --load) on a generated 3-class
    ImageFolder, in a fresh interpreter, with a tiny ``model`` put in the
    registry: all run, and afterwards no module of jax, flax, optax or the
    JAX package is loaded.  For vfefm_2b2 the fusion CLIs' mains,
    cli.fusion_train (one epoch) and cli.fusion_test, on generated CT/MRI
    pairs at the tiny options ``tiny``."""
    if model == "vfefm_2b2":
        return _fusion_mains_import_no_jax(tmp_path, tiny.split())
    root = tmp_path / "oct"
    for split in ("train", "val"):
        d = root / split
        d.mkdir(parents=True)
        _make_dataset(str(d), n=4, size=24)
        os.makedirs(d / "c", exist_ok=True)
        import cv2
        for i in range(4):
            cv2.imwrite(str(d / "c" / f"{i}.png"),
                        np.full((24, 24, 3), 40 * i, np.uint8))
    save = tmp_path / "runs" / "m.ckpt"
    code = (
        "import sys\n"
        "import medical_image_classification_tpu_torch.models.registry as r\n"
        f"orig = r._REGISTRY[{model!r}]\n"
        "def tiny(num_classes, **kw):\n"
        f"    kw.update({tiny})\n"
        "    return orig(num_classes, **kw)\n"
        f"r._REGISTRY[{model!r}] = tiny\n"
        "from medical_image_classification_tpu_torch.cli import (\n"
        "    cam, export, test, test_all_index, train)\n"
        f"train.main(train.parse_args(['--data-path', {str(root / 'train')!r},"
        f" '--model', {model!r}, '--num-classes', '3', '--epochs', '1',"
        " '--batch-size', '4', '--image-size', '16', '--device', 'cpu',"
        f" '--num-workers', '1', '--save-path', {str(save)!r}]))\n"
        f"acc = test.main(test.parse_args(['--data-path', "
        f"{str(root / 'val')!r}, '--model', {model!r}, '--num-classes', '3',"
        f" '--weights', {str(save) + '.best'!r}, '--batch-size', '4',"
        " '--image-size', '16', '--device', 'cpu']))\n"
        "assert 0.0 <= acc <= 1.0, acc\n"
        f"common = ['--model', {model!r}, '--num-classes', '3', "
        f"'--weights', {str(save) + '.best'!r}, '--image-size', '16', "
        "'--device', 'cpu']\n"
        f"data = ['--data-path', {str(root / 'val')!r}, '--batch-size', '4']\n"
        f"csv = {str(tmp_path / 'm.csv')!r}\n"
        "m = test.main(test.parse_args(common + data + ['--all-index', "
        "'--csv-out', csv]))\n"
        "assert m == test.main(test_all_index.parse_args(common + data + "
        "['--csv-out', csv])), m\n"
        f"img = {str(root / 'val' / 'c' / '1.png')!r}\n"
        f"heat = cam.main(cam.parse_args(common + ['--image', img, '--out', "
        f"{str(tmp_path / 'cam.png')!r}]))\n"
        "assert heat.shape == (16, 16), heat.shape\n"
        f"pt2 = {str(tmp_path / 'm.pt2')!r}\n"
        "export.main(export.parse_args(common + ['--batch-size', '2', "
        "'--dtype', 'fp32', '--out', pt2]))\n"
        "assert export.main(export.parse_args(['--load', pt2])).shape == "
        "(2, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', "
        "'medical_image_classification_tpu'))\n"
        "assert not bad, bad\n"
        "print('CLI_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_OK" in proc.stdout
    assert os.path.exists(str(save) + ".best")
    assert (tmp_path / "runs" / "class_indices.json").exists()


def _fusion_mains_import_no_jax(tmp_path, tiny):
    from test_torch_fusion_cli import make_pairs
    root = str(tmp_path / "ctmri")
    make_pairs(root, n=2, size=24)
    save, out = str(tmp_path / "f.pt"), str(tmp_path / "fused")
    code = (
        "import sys\n"
        "from medical_image_classification_tpu_torch.cli import "
        "fusion_test, fusion_train\n"
        f"fusion_train.main(fusion_train.parse_args(['--data-path', {root!r},"
        f" '--epochs', '1', '--device', 'cpu', '--save-path', {save!r}] + "
        f"{tiny!r}))\n"
        f"fusion_test.main(fusion_test.parse_args(['--data-path', {root!r}, "
        f"'--weights', {save!r}, '--out-dir', {out!r}, '--device', 'cpu'] + "
        f"{tiny!r}))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', "
        "'medical_image_classification_tpu'))\n"
        "assert not bad, bad\n"
        "print('CLI_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_OK" in proc.stdout
    assert sorted(os.listdir(out)) == ["0_fused.png", "1_fused.png"]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_image_folder_pipeline_matches_jax(tmp_path, train):
    """The port's copy of the ImageFolder pipeline against the JAX
    package's OpenCV path: the same scan and class_indices.json, and
    byte-identical batches over two epochs (shuffle and crop draws from the
    same seeds)."""
    from medical_image_classification_tpu.data import image_folder as jif
    from medical_image_classification_tpu.data import loader as jld
    from medical_image_classification_tpu_torch.data import image_folder as tif
    from medical_image_classification_tpu_torch.data import loader as tld
    root = str(tmp_path / "data")
    _make_dataset(root, n=5, size=40)
    jds, tds = jif.scan_image_folder(root), tif.scan_image_folder(root)
    assert (tds.samples, tds.classes) == (jds.samples, jds.classes)
    assert tif.dump_class_indices(tds, str(tmp_path / "t.json")) == \
        jif.dump_class_indices(jds, str(tmp_path / "j.json"))
    kw = dict(batch_size=4, image_size=24, train=train, seed=3,
              num_threads=2)
    jl = jld.BatchLoader(jds, use_native=False, **kw)
    tl = tld.BatchLoader(tds, **kw)
    assert tl.steps_per_epoch() == jl.steps_per_epoch()
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) == tl.steps_per_epoch()
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


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
