"""The nine SSD-family classifiers at d_state 16 (the directions coupled
through the state, N 64), built in the JAX package at a reduced config
(32x32, two stages of one block, dims 32 and 64, headdim 8, chunk 16) and
carried into the port, inputs from a numpy seed.  This file runs the
checks on cnn_mamba, cnn_mamba_mifa, kanin_ssd and kanout_ssd;
``test_torch_ssd16_heads.py`` runs them on MedSSD with each KAN head, at
one stage of one block (dims 32): the heads' backbone is MedSSD's, which
the names here hold at two stages.

For every name: fp32 eval logits within 2e-3 x max|logit| with the same
argmax, through both of the port's SSD paths (the einsum path, which is
what the JAX package takes at N 64: its dirs gate needs N % 128 == 0; and
the port's dirs path, its window widened to l >= 8 on the port's side
only, as on the card, where the port's gate has no lane term); one train
step's gradient tree against JAX's through the dirs path; in bf16 the
dtype at every stage boundary equal to the JAX model's (MIFA's fp32
promotion included); the weights carried exactly both ways.  For
cnn_mamba_mifa, kanin_ssd and medssd_3kan a 5-step Adam trajectory.
Drop-path is off here (its masks: ``test_torch_medmamba.py``).

The JAX weights are JAX inits: one of cnn_mamba_mifa (its stem, MIFA and
backbone serve cnn_mamba), one of medssd_ekan at one stage (its backbone
serves the head models, each with a JAX init of its head spliced in), one
each of kanin_ssd and kanout_ssd."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.kernels.ssd_fused_dirs as tsfd
from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    cross_entropy_loss as jax_cross_entropy,
    make_train_step as jax_make_train_step,
)
from medical_image_classification_tpu.data.image_folder import (
    normalize_batch as jax_normalize,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medssd_family_state_dict,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.eval_step import (
    make_eval_step,
)
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    TrainState,
    make_train_step,
)
from medical_image_classification_tpu_torch.utils.weights import (
    medssd_state_dict_from_jax,
)

torch.set_num_threads(2)

NAMES = ("cnn_mamba", "cnn_mamba_mifa", "kanin_ssd", "kanout_ssd",
         "medssd_ekan", "medssd_okan", "medssd_kan", "medssd_kanmodule",
         "medssd_3kan")
HEAD = {"medssd_ekan": "ekan", "medssd_okan": "okan",
        "medssd_kan": "kan_stack", "medssd_kanmodule": "kan_module",
        "medssd_3kan": "3kan"}
CFG = dict(depths=(1, 1), dims=(32, 64), ssd_headdim=8, ssd_chunk_size=16)
# the head models at one stage (their backbone is MedSSD's, which the
# backbone names cover at two): half the JAX programs to trace and compile
HEAD_CFG = dict(CFG, depths=(1,), dims=(32,))
HEAD_BASE = "medssd_ekan"           # whose JAX init lends them its backbone
NUM_CLASSES, BATCH, SIZE = 8, 4, 32
# the JAX leaves moved away from init (norm scales and biases, the SSD
# parameters, the BatchNorm means)
PERTURB = ("bias", "scale", "A_logs", "dt_bias", "Ds", "norm_weight", "mean")


def jax_trees_of_port_names(sd):
    """The JAX importer's reverse for the names the reference has none
    for: a port ``state_dict``'s MIFA and in-block KAN entries ->
    {"params": ..., "kan_state": ...} subtrees under the JAX module names
    (nested dicts of numpy arrays), to merge with what
    ``import_medssd_family_state_dict`` reads."""
    params: dict = {}
    kan_state: dict = {}

    def at(tree, path):
        for name in path:
            tree = tree.setdefault(name, {})
        return tree

    def jax_path(key):
        out = []
        parts = key.split(".")
        while parts:
            name = parts.pop(0)
            if name in ("layers", "blocks"):
                name = f"{name}_{parts.pop(0)}"
            out.append(name)
        return out

    for key, t in sd.items():
        a = t.detach().cpu().numpy()
        path = jax_path(key)
        if path[0] == "mifa":
            if key == "mifa.eca.conv.weight":
                at(params, path[:-1])["kernel"] = a.transpose(2, 1, 0)
            elif path[-1] == "weight":
                at(params, path[:-1])["kernel"] = a.transpose(2, 3, 1, 0)
            else:
                at(params, path[:-1])["bias"] = a
        elif len(path) > 2 and path[-2] in ("filter_kan", "in_proj_kan"):
            tree = kan_state if path[-1] == "grid" else params
            at(tree, path[:-1])[path[-1]] = a
    return {"params": params, "kan_state": kan_state}


def _cfg(name):
    return HEAD_CFG if name in HEAD else CFG


@functools.lru_cache(maxsize=None)
def _jax_model(name, dtype=None):
    return jax_create(name, num_classes=NUM_CLASSES, drop_path_rate=0.0,
                      dtype=dtype, **_cfg(name))


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    variables = jax.jit(_jax_model(name).init)(
        {"params": jax.random.PRNGKey(0)},
        np.zeros((1, SIZE, SIZE, 3), np.float32))
    return {col: to_np(variables[col]) for col in
            ("params", "batch_stats", "kan_state") if col in variables}


def _jax_head_init(kind):
    """A JAX init of the head alone, on the pooled features."""
    from medical_image_classification_tpu.models.kan_modules import (
        ClassifierHead)
    head = ClassifierHead(NUM_CLASSES, kind=kind,
                          ekan_spline_order=3 if kind == "ekan" else 1)
    v = jax.jit(head.init)(jax.random.PRNGKey(1),
                           np.zeros((1, HEAD_CFG["dims"][-1]), np.float32))
    return {col: jax.tree_util.tree_map(np.asarray, dict(t))
            for col, t in v.items()}


@functools.lru_cache(maxsize=None)
def _jax_weights(name):
    """The JAX weights of ``name``, perturbed: {params, batch_stats,
    kan_state} as nested dicts of numpy arrays."""
    if name in ("kanin_ssd", "kanout_ssd"):
        variables = _jax_init(name)
    elif name in HEAD:
        variables = {col: {k: v for k, v in t.items() if k != "classifier"}
                     for col, t in _jax_init(HEAD_BASE).items()}
        for col, t in _jax_head_init(HEAD[name]).items():
            variables.setdefault(col, {})["classifier"] = t
    else:
        base = _jax_init("cnn_mamba_mifa")
        variables = {col: dict(t) for col, t in base.items()}
        if name != "cnn_mamba_mifa":
            del variables["params"]["mifa"]
    rng = np.random.default_rng(NAMES.index(name))

    def perturb(node):
        return {k: (perturb(v) if hasattr(v, "items") else
                    np.asarray(v) + (0.2 * rng.standard_normal(np.shape(v))
                                     .astype(np.float32)
                                     if k in PERTURB else 0.0))
                for k, v in node.items()}

    return {col: perturb(t) for col, t in variables.items()}


def _state(w):
    return {k: v for k, v in w.items() if k != "params"}


def _port(name, w, **kw):
    model = create_model(name, NUM_CLASSES, drop_path_rate=0.0,
                         **_cfg(name), **kw)
    model.load_state_dict(medssd_state_dict_from_jax(
        w["params"], w["batch_stats"], w.get("kan_state")), strict=True)
    return model


def _images(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, NUM_CLASSES, (BATCH,), dtype=np.int32))


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    """One jitted JAX program: eval logits on batch 1, and the train loss
    and its gradient tree on batch 3 (train mode, batch statistics)."""
    model, w = _jax_model(name), _jax_weights(name)
    rest = _state(w)
    (e_imgs, _), (t_imgs, t_labels) = _images(1), _images(3)

    def run(params):
        logits = model.apply({"params": params, **rest},
                             jax_normalize(e_imgs), train=False)

        def loss_fn(p):
            out, _ = model.apply({"params": p, **rest},
                                 jax_normalize(t_imgs), train=True,
                                 mutable=["batch_stats"])
            return jax_cross_entropy(out, t_labels)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return logits, loss, grads

    logits, loss, grads = jax.jit(run)(w["params"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return np.asarray(logits), float(loss), to_np(grads)


def _dirs_calls(monkeypatch):
    """Widen the port's dirs window to l >= 8 and count its plain twin's
    forward and backward calls."""
    monkeypatch.setattr(tssd, "_MIN_L", 8)
    calls = []
    for name in ("ssd_fused_dirs_fwd_ref", "ssd_fused_dirs_bwd_ref"):
        fn = getattr(tsfd, name)
        monkeypatch.setattr(tsfd, name, lambda *a, fn=fn, name=name, **k:
                            calls.append(name) or fn(*a, **k))
    return calls


def test_stage_paths_of_the_reduced_models():
    """The reduced models' SSD dispatch: the einsum path at every stage by
    default (N 64 < the window); with the window widened on the port's
    side, the dirs path at both stages (L 64 at chunk 16, L 16 at chunk 8),
    as the full models take it at their stages 0-1 at 224x224 on the card;
    the JAX gate refuses N 64 (not a multiple of 128)."""
    import medical_image_classification_tpu.kernels.ssd as jssd
    stages = [(64, 32), (16, 64)]
    chunk = lambda L, d: tssd.ssd_dirs_chunk(L, 16, 64, 8, 4 * d // 8, d)
    assert [chunk(L, d) for L, d in stages] == [None] * 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tssd, "_MIN_L", 8)
        assert [chunk(L, d) for L, d in stages] == [16, 8]
    assert jssd.ssd_dirs_chunk(64, 16, 64, 8, 16, 1, 32) is None


def check_eval_logits(name, monkeypatch):
    """fp32 logits within 2e-3 x max|logit|, the same argmax, through the
    einsum path and through the dirs twin (one forward at each stage)."""
    logits_j = _jax_results(name)[0]
    imgs, labels = _images(1)
    scale = float(np.abs(logits_j).max())
    port = _port(name, _jax_weights(name))
    args = torch.from_numpy(imgs), torch.from_numpy(labels).long()
    outs = [make_eval_step(port)(*args)[1]]
    calls = _dirs_calls(monkeypatch)
    outs.append(make_eval_step(port)(*args)[1])
    assert calls == ["ssd_fused_dirs_fwd_ref"] * len(_cfg(name)["depths"])
    for logits_t in outs:
        assert logits_t.dtype == torch.float32
        np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=0,
                                   atol=2e-3 * scale)
        np.testing.assert_array_equal(logits_t.numpy().argmax(-1),
                                      logits_j.argmax(-1))


def _grads_close(got, want, rtol=2e-2, min_cos=0.998, abs_floor=2e-4):
    """Leaf-wise rel-norm and cosine (tests/test_reference_grad_parity.py
    :70-98): a leaf passes if its error norm is under ``abs_floor`` or its
    rel-norm error is <= rtol with cosine > min_cos."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k].double().numpy().ravel()
        w = w.double().numpy().ravel()
        diff = np.linalg.norm(g - w)
        if diff <= abs_floor:
            continue
        nw = np.linalg.norm(w)
        cos = float(g @ w / (np.linalg.norm(g) * nw + 1e-30))
        assert diff / nw <= rtol and cos > min_cos, (k, diff / nw, cos)


def check_train_step_grads(name, monkeypatch):
    """One train-mode loss on the same batch through the port's dirs path
    (forward and backward twins at each stage): the loss within 2e-4
    relative, every parameter's gradient leaf-wise within rel-norm 2e-2
    and cosine 0.998 above 2e-4 (fp32; the dirs twin and the einsums sum
    in other orders)."""
    _, loss_j, grads_j = _jax_results(name)
    w = _jax_weights(name)
    calls = _dirs_calls(monkeypatch)
    port = _port(name, w).train()
    from medical_image_classification_tpu_torch.data.image_folder import (
        normalize_batch)
    from medical_image_classification_tpu_torch.train.train_step import (
        cross_entropy_loss)
    imgs, labels = _images(3)
    loss = cross_entropy_loss(port(normalize_batch(torch.from_numpy(imgs))),
                              torch.from_numpy(labels).long())
    loss.backward()
    stages = len(_cfg(name)["depths"])
    assert sorted(calls) == ["ssd_fused_dirs_bwd_ref"] * stages + \
        ["ssd_fused_dirs_fwd_ref"] * stages
    assert abs(float(loss.detach()) - loss_j) <= 2e-4 * abs(loss_j)
    want = medssd_state_dict_from_jax(grads_j, w["batch_stats"],
                                      w.get("kan_state"))
    got = {n: p.grad for n, p in port.named_parameters()}
    _grads_close(got, {n: want[n] for n in got})


def check_adam_trajectory(name, monkeypatch):
    """Adam at lr 1e-4, a new batch each step, 5 steps, the port on its
    dirs path: the per-step losses within rtol 1e-2 (the ladder of the
    MedSSD trajectory test) and every parameter moved."""
    w = _jax_weights(name)
    batches = [_images(10 + i) for i in range(5)]
    state = JaxTrainState.create(w["params"], _state(w), optax.adam(1e-4))
    step_j = jax_make_train_step(_jax_model(name), donate=False)
    losses_j = []
    for imgs, labels in batches:
        state, metrics = step_j(state, imgs, labels, jax.random.PRNGKey(0))
        losses_j.append(float(metrics["loss"]))
    _dirs_calls(monkeypatch)
    port = _port(name, w)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = make_optimizer("adam", port.named_parameters())
    step = make_train_step(port, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)), state=TrainState())
    losses_t = [float(step(torch.from_numpy(i),
                           torch.from_numpy(l).long())["loss"])
                for i, l in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2, atol=2e-4)
    still = [n for n, p in port.named_parameters()
             if torch.equal(p, before[n])]
    assert not still, still


def _jax_boundaries(name):
    """The dtype of each stage boundary in the JAX model at bf16 compute
    (``capture_intermediates``, shapes only): the stem, the patch embed,
    MIFA, every block and every stage, the logits."""
    model = _jax_model(name, jnp.bfloat16)
    w = _jax_weights(name)
    x = jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float32)
    logits, inter = jax.eval_shape(
        lambda v: model.apply(v, x, capture_intermediates=True,
                              mutable=["intermediates"]),
        {"params": w["params"], **_state(w)})
    out = {"logits": logits.dtype}
    tree = inter["intermediates"]
    for key in ("conv_t_conv", "patch_embed", "mifa"):
        if key in tree:
            out[key] = tree[key]["__call__"][0].dtype
    depths = _cfg(name)["depths"]
    for i in range(len(depths)):
        layer = tree[f"layers_{i}"]
        out[f"layers_{i}"] = layer["__call__"][0].dtype
        for j in range(depths[i]):
            out[f"layers_{i}.blocks_{j}"] = \
                layer[f"blocks_{j}"]["__call__"][0].dtype
    return {k: str(v) for k, v in out.items()}


def check_bf16_stage_dtypes(name):
    """bf16 compute, fp32 parameters: each stage boundary's dtype equals the
    JAX model's (after MIFA the residual stream is fp32 until the first
    patch merge), and the logits are finite fp32."""
    want = _jax_boundaries(name)
    port = create_model(name, NUM_CLASSES, drop_path_rate=0.0,
                        dtype=torch.bfloat16, **_cfg(name))
    port.load_state_dict(_port(name, _jax_weights(name)).state_dict())
    got = {}
    mods = {"conv_t_conv": port.conv_T_conv, "patch_embed": port.patch_embed,
            "mifa": port.mifa}
    for i, layer in enumerate(port.layers):
        mods[f"layers_{i}"] = layer
        for j, blk in enumerate(layer.blocks):
            mods[f"layers_{i}.blocks_{j}"] = blk
    for key, mod in mods.items():
        if mod is not None:
            mod.register_forward_hook(
                lambda m, a, out, key=key: got.__setitem__(
                    key, str(out.dtype).replace("torch.", "")))
    x = torch.from_numpy(np.random.default_rng(0).random(
        (BATCH, SIZE, SIZE, 3), dtype=np.float32))
    with torch.inference_mode():
        logits = port.eval()(x)
    got["logits"] = str(logits.dtype).replace("torch.", "")
    assert got == want
    assert bool(torch.isfinite(logits).all())
    if name == "cnn_mamba_mifa":
        assert got["mifa"] == got["layers_0.blocks_0"] == "float32"


def check_weights_carry_exactly_both_ways(name):
    """JAX -> port: every parameter and buffer of the port written (a strict
    load) from exactly its JAX leaf.  Port -> JAX: the JAX importer
    (``import_medssd_family_state_dict``) on the port's state_dict, plus
    ``jax_trees_of_port_names`` for MIFA and the in-block KANs, which the
    reference does not name, gives back every JAX leaf bit for bit.
    kaninSSD has no in_proj, which the importer reads, so it gets a stand-in
    that is dropped again."""
    w = _jax_weights(name)
    sd = _port(name, w).state_dict()
    feed = dict(sd)
    kanin = name == "kanin_ssd"
    if kanin:
        for k in [k for k in sd if k.endswith("in_proj_kan.base_weight")]:
            feed[k.replace("in_proj_kan.base_weight", "in_proj.weight")] = \
                sd[k]
    params, variables = import_medssd_family_state_dict(
        feed, head=HEAD.get(name, "linear"), depths=_cfg(name)["depths"],
        dims=_cfg(name)["dims"], headdim=CFG["ssd_headdim"],
        conv_stem=name.startswith("cnn_mamba"))
    extra = jax_trees_of_port_names(sd)

    def merge(a, b):
        for k, v in b.items():
            a[k] = merge(a.get(k, {}), v) if isinstance(v, dict) else v
        return a

    got = {"params": merge(params, extra["params"]),
           "batch_stats": variables["batch_stats"]}
    if "kan_state" in w:
        got["kan_state"] = merge(variables.get("kan_state", {}),
                                 extra["kan_state"])

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    for col in w:
        want_f, got_f = flat(w[col]), flat(got[col])
        if kanin and col == "params":
            got_f = {k: v for k, v in got_f.items()
                     if "['in_proj']" not in k}
        assert set(want_f) == set(got_f), (col, set(want_f) ^ set(got_f))
        for k in want_f:
            np.testing.assert_array_equal(got_f[k], want_f[k], err_msg=k)


BACKBONES = ("cnn_mamba", "cnn_mamba_mifa", "kanin_ssd", "kanout_ssd")


@pytest.mark.parametrize("name", BACKBONES)
def test_eval_logits_match_jax(name, monkeypatch):
    check_eval_logits(name, monkeypatch)


@pytest.mark.parametrize("name", BACKBONES)
def test_train_step_grads_match_jax(name, monkeypatch):
    check_train_step_grads(name, monkeypatch)


@pytest.mark.parametrize("name", ["cnn_mamba_mifa", "kanin_ssd"])
def test_adam_trajectory_matches_jax(name, monkeypatch):
    check_adam_trajectory(name, monkeypatch)


@pytest.mark.parametrize("name", BACKBONES)
def test_bf16_stage_dtypes_match_jax(name):
    check_bf16_stage_dtypes(name)


@pytest.mark.parametrize("name", BACKBONES)
def test_weights_carry_exactly_both_ways(name):
    check_weights_carry_exactly_both_ways(name)
