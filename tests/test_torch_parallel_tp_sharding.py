"""``parallel/sharding.py`` alone, in one process (no ranks): the layout
of tensor parallelism over the model axis.

For each of the 15 classifier names (reduced widths; the rules do not
depend on them): every ``state_dict`` entry is split by a named rule or
replicated, the split ones exactly the SS2D / SS2DSSD leaves that the
JAX package's ``_spec_for`` shards, one to one; the ranks' pieces join
back into the full ``state_dict`` bit for bit, and each rank's loads
strictly into the model built with ``model_axis``.  Adam's moments cut
and join the same way; ``redundant_grads`` lists the B/C blocks, the ST
tail and ``in_proj_kan``; a tp that does not divide a stage's width
raises naming the stage."""

import jax
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.parallel.sharding import _spec_for
from medical_image_classification_tpu_torch.models import (
    available_models,
    create_model,
)
from medical_image_classification_tpu_torch.parallel import sharding
from medical_image_classification_tpu_torch.parallel.mesh import (
    Mesh,
    set_current_mesh,
)
from medical_image_classification_tpu_torch.train.optim import make_optimizer

NAMES = ("medmamba", "medmamba_t", "medmamba_s", "medmamba_b", "medssd",
         "cnn_mamba", "cnn_mamba_mifa", "st_ssd", "kanin_ssd", "kanout_ssd",
         "medssd_ekan", "medssd_okan", "medssd_kan", "medssd_kanmodule",
         "medssd_3kan")
CFG = dict(depths=(1, 1), dims=(16, 32), d_state=4, ssd_headdim=8)
TP = 2
# the port's leaf names under a block's self_attention -> the JAX ones
JAX_LEAF = {"in_proj.weight": "in_proj/kernel",
            "conv2d.weight": "conv2d/kernel", "conv2d.bias": "conv2d/bias",
            "out_proj.weight": "out_proj/kernel",
            "out_norm.weight": "out_norm/scale",
            "out_norm.bias": "out_norm/bias", "norm.weight": "norm_weight"}
# the layers' children that stay replicated
REPLICATED = ("stl.", "stf.", "o_norm.", "o_linear.", "k_weights",
              "in_proj_kan.", "filter_kan.")


def _cfg(name):
    return dict(CFG, st_tokens=(8, 4)) if name == "st_ssd" else CFG


def _tp_model(name, rank, **kw):
    set_current_mesh(Mesh(1, TP, 1, rank))
    try:
        return create_model(name, 3, model_axis="model", **_cfg(name), **kw)
    finally:
        set_current_mesh(None)


def _jax_split_leaves(name):
    """The JAX params paths that ``_spec_for`` shards over 'model'."""
    model = jax_create(name, num_classes=3, **_cfg(name))
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            np.zeros((1, 32, 32, 3), np.float32))
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0]:
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        if "model" in tuple(_spec_for(names, leaf)):
            out.add("/".join(names))
    return out


def _jax_path(key):
    pre, leaf = key.split(".self_attention.")
    parts = pre.split(".")
    return "/".join(f"{a}_{b}" for a, b in zip(parts[::2], parts[1::2])) \
        + "/self_attention/" + JAX_LEAF.get(leaf, leaf)


def test_the_fifteen_names():
    assert sorted(NAMES) == sorted(n for n in available_models())


@pytest.mark.parametrize("name", NAMES)
def test_layout_round_trip_and_jax_rules(name):
    gen = torch.Generator().manual_seed(1)
    sd = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point()
          else v for k, v in create_model(name, 3, **_cfg(name))
          .state_dict().items()}
    rules = sharding.split_rules({k: tuple(v.shape) for k, v in sd.items()})
    split = set(rules)
    assert split and all(".self_attention." in k and rules[k].rule
                         for k in split)
    for k in sd:
        if ".self_attention." in k and k not in split:
            assert k.split(".self_attention.")[1].startswith(REPLICATED), k
    assert {_jax_path(k) for k in split} == _jax_split_leaves(name)

    pieces = [sharding.shard_state_dict(sd, Mesh(1, TP, 1, r))
              for r in range(TP)]
    full = sharding.join_state_dicts(pieces)
    assert list(full) == list(sd)
    for k, t in sd.items():
        assert full[k].dtype == t.dtype and torch.equal(full[k], t), k
    for k in split:
        assert pieces[0][k].numel() < sd[k].numel(), k
        assert not torch.equal(pieces[0][k], pieces[1][k]), k
    for r, piece in enumerate(pieces):
        _tp_model(name, r).load_state_dict(piece, strict=True)


def test_optimizer_moments_cut_and_join():
    """Adam's state after one step of the full reduced medssd, cut to each
    rank's moments (``shard_optimizer_state``) and loaded into the ranks'
    optimizers, joins back into the full moments bit for bit."""
    name = "medssd"
    model = create_model(name, 3, generator=torch.Generator().manual_seed(2),
                         **CFG)
    opt = make_optimizer("adam", model.named_parameters())
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=torch.Generator()
                             .manual_seed(p.numel()))
    opt.step()
    names = sharding.param_names(opt, model)
    full = opt.state_dict()
    cut = []
    for r in range(TP):
        m = _tp_model(name, r)
        o = make_optimizer("adam", m.named_parameters())
        o.load_state_dict(sharding.shard_optimizer_state(
            full, o, m, Mesh(1, TP, 1, r)))
        cut.append(o.state_dict())
    for key in ("exp_avg", "exp_avg_sq"):
        joined = sharding.join_state_dicts(
            [{names[i]: st[key] for i, st in c["state"].items()}
             for c in cut])
        for i, st in full["state"].items():
            assert torch.equal(joined[names[i]], st[key]), (key, names[i])
    assert all(torch.equal(c["state"][0]["step"], full["state"][0]["step"])
               for c in cut)


@pytest.mark.parametrize("name", ["medmamba", "medssd", "st_ssd",
                                  "kanin_ssd", "kanout_ssd"])
def test_redundant_grads_and_square_sums(name):
    """The gradient pieces each model rank holds a share of: the B/C
    blocks of SS2DSSD's in_proj rows and conv channels, and the ST tail's
    and in_proj_kan's whole leaves; none for Mamba-1's SS2D, nor
    filter_kan, which lies before the region.  A split leaf's squares are
    its split blocks' plus its replicated blocks'."""
    m = _tp_model(name, 0)
    named = dict(m.named_parameters())
    got = []
    for p, idx in sharding.redundant_grads(m.named_parameters(), TP):
        n = next(k for k, q in named.items() if q is p)
        got.append((n, tuple(p[idx].shape)))
    leaf = lambda n: n.split(".self_attention.")[1]
    if name == "medmamba":
        assert got == []
        return
    N, d = CFG["d_state"], 8                 # stage 0: a rank's d_ssm 8
    for n, shape in got:
        if leaf(n) == "in_proj.weight" or leaf(n).startswith("conv2d."):
            assert shape[0] == N, n          # B, then C
        else:
            assert leaf(n).startswith(REPLICATED[:-1]), n
            assert shape == tuple(named[n].shape)
    kinds = sorted(leaf(n).split(".")[0] for n, _ in got
                   if "layers.0." in n)
    bc = ["conv2d"] * 4 + ([] if name == "kanin_ssd" else ["in_proj"] * 2)
    tail = {"st_ssd": ["k_weights", "o_linear", "o_linear", "o_norm",
                       "o_norm", "stf", "stf", "stf", "stl", "stl", "stl",
                       "stl"],
            "kanin_ssd": ["in_proj_kan"] * len(
                [n for n in named if n.startswith(
                    "layers.0.blocks.0.self_attention.in_proj_kan.")])}
    assert kinds == sorted(bc + tail.get(name, []))
    rules = sharding.split_rules({k: tuple(v.shape)
                                  for k, v in named.items()}, TP, local=True)
    key = next(k for k in rules if k.endswith("conv2d.weight"))
    t = torch.randn(named[key].shape)
    s, r = sharding.split_sq_sums(t, rules[key], TP)
    assert float(s + r) == pytest.approx(float((t * t).sum()), rel=1e-6)
    assert float(r) == pytest.approx(float((t[d:d + 2 * N] ** 2).sum()),
                                     rel=1e-6)


def test_tp_that_does_not_divide_raises_naming_the_stage():
    """tp 3 splits no stage of the reduced medmamba (d_inner 16, 32), tp 4
    not the reduced medssd's 2 heads at stage 0; a full state_dict cut
    over 3 ranks raises too."""
    set_current_mesh(Mesh(1, 3, 1, 0))
    try:
        with pytest.raises(ValueError, match=r"stage 0 .*d_inner 16"):
            create_model("medmamba", 3, model_axis="model", **CFG)
    finally:
        set_current_mesh(None)
    set_current_mesh(Mesh(1, 4, 1, 0))
    try:
        with pytest.raises(ValueError, match=r"stage 0 .*heads 2"):
            create_model("medssd", 3, model_axis="model", **CFG)
    finally:
        set_current_mesh(None)
    sd = create_model("medmamba", 3, **CFG).state_dict()
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_state_dict(sd, Mesh(1, 3, 1, 0))
