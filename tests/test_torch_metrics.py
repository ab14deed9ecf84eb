"""The port's metric suite against the JAX package's ``evaluate/metrics.py``
(exactly, on seeded labels and scores with a class that has no positives
and with ties), ``count_parameters`` against the JAX count of ``params``
at full width (``jax.eval_shape`` of the init: nothing compiles), and
``cli/test.py --all-index`` against the JAX CLI on a tiny ImageFolder with
the same weights: the same CSV columns, the same numbers."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.evaluate.metrics as jm
import medical_image_classification_tpu_torch.evaluate.metrics as tm

torch.set_num_threads(1)

# the JAX CLI's CSV header (classification_metrics, param_count, model)
COLUMNS = ["accuracy", "precision_macro", "recall_macro",
           "specificity_macro", "f1_macro", "auc_ovr_macro", "param_count",
           "model"]


def _labels_scores(seed, n=60, classes=5, tie=False):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes - 1, n)          # the last class: none
    scores = rng.random((n, classes))
    scores[np.arange(n), y] += 0.3
    if tie:                                      # ties within and across
        scores[::3, 1] = 0.5                     # the classes' ranks
        scores[1::7] = scores[0]
    return y, scores.argmax(1), scores


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_the_jax_suite(seed, tie):
    y, pred, scores = _labels_scores(seed, tie=tie)
    np.testing.assert_array_equal(tm.confusion_matrix(y, pred, 5),
                                  jm.confusion_matrix(y, pred, 5))
    assert tm.roc_auc_ovr(y, scores) == jm.roc_auc_ovr(y, scores)
    for nc in (None, 5, 7):
        got = tm.classification_metrics(y, pred, scores, num_classes=nc)
        want = jm.classification_metrics(y, pred, scores, num_classes=nc)
        assert list(got) == list(want) and got == want
    assert tm.classification_metrics(y, pred) == jm.classification_metrics(
        y, pred)
    # one class only: no AUC term at all
    assert np.isnan(tm.roc_auc_ovr(np.zeros(4, int), np.ones((4, 2))))


def test_csv_equals_the_jax_csv(tmp_path):
    y, pred, scores = _labels_scores(2)
    m = tm.classification_metrics(y, pred, scores, num_classes=5)
    m["param_count"] = 17
    tm.metrics_to_csv(str(tmp_path / "t.csv"), m, extra={"model": "x"})
    jm.metrics_to_csv(str(tmp_path / "j.csv"), m, extra={"model": "x"})
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv") \
        .read_bytes()


def _jax_param_count(name):
    from medical_image_classification_tpu.models import create_model
    model = create_model(name, num_classes=8)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 224, 224, 3)), train=False))
    return jm.count_parameters(shapes["params"]), shapes


def _check_count(name):
    from medical_image_classification_tpu_torch.models import create_model
    with torch.device("meta"):
        model = create_model(name, 8)
    want, shapes = _jax_param_count(name)
    assert tm.count_parameters(model) == want, name
    return model, shapes


@pytest.mark.parametrize("name", ["medmamba", "medssd", "st_ssd",
                                  "medssd_ekan", "medssd_okan"])
def test_count_parameters_equals_jax(name):
    """Full width; the KAN heads' grids are buffers in the port and
    ``kan_state`` in JAX: neither package counts them."""
    model, shapes = _check_count(name)
    if name in ("medssd_ekan", "medssd_okan"):
        buffers = [n for n, _ in model.named_buffers() if "grid" in n]
        assert buffers and not any("grid" in n for n, _ in
                                   model.named_parameters())
        leaves = [jax.tree_util.keystr(k) for k, _ in
                  jax.tree_util.tree_flatten_with_path(shapes["params"])[0]]
        assert not any("grid" in k for k in leaves)
        assert "kan_state" in shapes


@pytest.mark.slow
@pytest.mark.parametrize("name", ["medmamba_t", "medmamba_s", "medmamba_b",
                                  "cnn_mamba", "cnn_mamba_mifa", "kanin_ssd",
                                  "kanout_ssd", "medssd_kan",
                                  "medssd_kanmodule", "medssd_3kan"])
def test_count_parameters_equals_jax_other_names(name):
    _check_count(name)


def test_registries_hold_the_same_single_input_names():
    from medical_image_classification_tpu.models import available_models
    from medical_image_classification_tpu_torch.models import (
        available_models as port_models)
    names = {"medmamba", "medssd", "st_ssd", "medssd_ekan", "medssd_okan",
             "medmamba_t", "medmamba_s", "medmamba_b", "cnn_mamba",
             "cnn_mamba_mifa", "kanin_ssd", "kanout_ssd", "medssd_kan",
             "medssd_kanmodule", "medssd_3kan"}
    assert set(available_models()) == set(port_models()) == names


def _image_folder(root, classes=3, n=4, size=24):
    import cv2
    rng = np.random.RandomState(0)
    for c in range(classes):
        d = os.path.join(root, f"c{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            cv2.imwrite(os.path.join(d, f"{i}.png"),
                        rng.randint(0, 256, (size, size, 3), np.uint8))


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2
    return rows[0], rows[1]


def test_all_index_cli_equals_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs' ``main`` with ``--all-index --csv-out`` on one tiny
    ImageFolder (12 images, batch 5: the last batch padded) and the same
    tiny medmamba: the JAX CLI with its init (PRNGKey 0), the port with
    those weights carried over.  The CSVs have JAX's columns in JAX's
    order, the same model name and parameter count, and the same metrics
    (the AUC within 1e-9: the logits differ by summation order only)."""
    from medical_image_classification_tpu.cli import test as jcli
    from medical_image_classification_tpu.models import registry as jreg
    from medical_image_classification_tpu.train.optim import make_optimizer
    from medical_image_classification_tpu.train.train_state import (
        init_train_state)
    from medical_image_classification_tpu_torch.cli import (
        test as tcli, test_all_index)
    from medical_image_classification_tpu_torch.models import registry
    from medical_image_classification_tpu_torch.utils.weights import (
        medmamba_state_dict_from_jax)
    tiny = dict(depths=(1, 1), dims=(16, 32), d_state=4, drop_path_rate=0.0)
    for reg in (jreg, registry):
        orig = reg._REGISTRY["medmamba"]
        monkeypatch.setitem(reg._REGISTRY, "medmamba",
                            lambda num_classes, orig=orig, **kw:
                            orig(num_classes, **{**kw, **tiny}))
    root = str(tmp_path / "data")
    _image_folder(root)
    flags = ["--data-path", root, "--num-classes", "3", "--batch-size", "5",
             "--image-size", "32"]
    jcsv, tcsv, acsv = (str(tmp_path / f) for f in ("j.csv", "t.csv",
                                                    "a.csv"))
    jcli.main(tcli.parse_args(flags + ["--all-index", "--csv-out", jcsv]))

    model = jreg.create_model("medmamba", num_classes=3)
    state = init_train_state(
        model, jax.random.PRNGKey(0),
        jnp.zeros((5, 32, 32, 3), jnp.uint8), make_optimizer("adam", 1e-4))
    weights = str(tmp_path / "w.pt")
    torch.save(medmamba_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray,
                               state.model_state["batch_stats"])), weights)
    port = ["--weights", weights, "--device", "cpu"]
    m = tcli.main(tcli.parse_args(flags + port + ["--all-index",
                                                  "--csv-out", tcsv]))
    tcli.main(test_all_index.parse_args(flags + port + ["--csv-out", acsv]))

    jh, jrow = _read_csv(jcsv)
    th, trow = _read_csv(tcsv)
    assert jh == th == COLUMNS and _read_csv(acsv) == (th, trow)
    assert trow[-2:] == jrow[-2:] == [str(m["param_count"]), "medmamba"]
    np.testing.assert_allclose([float(v) for v in trow[:-2]],
                               [float(v) for v in jrow[:-2]], rtol=0,
                               atol=1e-9)
    assert m["param_count"] == jm.count_parameters(state.params)


def test_chip_smoke_pins_the_jax_columns():
    import chip_smoke
    assert list(chip_smoke.ALL_INDEX_COLUMNS) == COLUMNS
