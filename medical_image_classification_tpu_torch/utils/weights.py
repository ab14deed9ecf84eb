"""Carry MedMamba, the MedSSD family (MedSSD, CNN-Mamba, ST-SSD, the KAN
models), the CrossMamba family (the cross classifiers, the fusion U-Nets)
and Mamba-1 LM weights from the JAX package to the port.

The reverse of ``medical_image_classification_tpu/utils/torch_import.py::
import_medmamba_state_dict``, ``import_medssd_family_state_dict`` (with
``st_tokens=True`` for ST-SSD, ``conv_stem=True`` for CNN-Mamba and
``head=`` for the KAN heads), ``import_cross_classifier_state_dict`` and
``import_vfefm_state_dict``: the JAX ``params``, ``batch_stats`` and
``kan_state`` trees (nested dicts of numpy arrays) become the port's
``state_dict``, ready for ``load_state_dict(strict=True)``.  The port names
its parameters as the reference ``state_dict`` does, so the JAX importers
map a port ``state_dict()`` back to the JAX trees.  The reference has no
names for MIFA (``mifa.*``) and the in-block KANs (``filter_kan``,
``in_proj_kan``), so the port names those as the JAX modules do.

Layouts: Dense kernel [in, out] -> Linear weight [out, in]; Conv HWIO ->
OIHW; MedMamba ``A_logs`` [K, d_inner, N] -> [K * d_inner, N] and ``Ds``
[K, d_inner] -> [K * d_inner]; MedSSD ``A_logs`` and ``Ds`` [K, nheads] ->
[K * nheads], ``dt_bias`` [K, nheads] as it is, ``norm_weight`` ->
``norm.weight``; the ECA's 1-D conv kernel [k, 1, 1] -> [1, 1, k]; the
KAN layers' parameters and their ``grid`` / ``mask`` buffers as they are;
ST-SSD's ``stl``/``stf`` ``u1``, ``u2``, ``z`` ->
``learnable_*`` and the Dense(2 -> 1) ``mix`` kernel [2, 1] -> the
``conv1d`` weight [1, 2, 1], ``o_norm`` with its batch stats, ``o_linear``
and ``k_weights``; CrossMamba's parameters as MedSSD's core's, and the
U-Nets' scanned, vmapped block pairs [depth, 2, ...] unstacked.  The Mamba LM (``mamba_lm_state_dict``) is the exact
inverse of ``import_mamba_lm_state_dict``, with the HF names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _count(tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _writer(sd: Dict[str, torch.Tensor]):
    """Helpers that write JAX leaves into ``sd`` under a port prefix: put
    (an fp32 copy, never a view of the JAX array), dense, conv, ln, bn (with
    its batch stats) and kan."""

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def dense(prefix, p):
        put(prefix + ".weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            put(prefix + ".bias", p["bias"])

    def conv(prefix, p):
        put(prefix + ".weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            put(prefix + ".bias", p["bias"])

    def ln(prefix, p):
        put(prefix + ".weight", p["scale"])
        put(prefix + ".bias", p["bias"])

    def bn(prefix, p, s):
        ln(prefix, p)
        put(prefix + ".running_mean", s["mean"])
        put(prefix + ".running_var", s["var"])
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    def kan(prefix, p, s):
        for name, arr in {**p, **s}.items():
            put(f"{prefix}.{name}", arr)

    return dict(put=put, dense=dense, conv=conv, ln=ln, bn=bn, kan=kan)


def _ssconv_block(h, p, blk, stats, self_attention, sa_kan=None):
    """One SS-Conv block (params ``blk``, batch stats ``stats``) under the
    prefix ``p``."""
    h["ln"](p + ".ln_1", blk["ln_1"])
    self_attention(h, p + ".self_attention", blk["self_attention"],
                   stats.get("self_attention"), sa_kan)
    cb, cs = blk["conv_branch"], stats["conv_branch"]
    c = p + ".conv33conv33conv11"
    h["bn"](c + ".0", cb["bn0"], cs["bn0"])
    h["conv"](c + ".1", cb["conv1"])
    h["bn"](c + ".2", cb["bn1"], cs["bn1"])
    h["conv"](c + ".4", cb["conv2"])
    h["bn"](c + ".5", cb["bn2"], cs["bn2"])
    h["conv"](c + ".7", cb["conv3"])


def _merging(h, p, m):
    h["ln"](p + ".norm", m["norm"])
    h["put"](p + ".reduction.weight", np.asarray(m["reduction"]["kernel"]).T)


def _vssm_state_dict(params, batch_stats, self_attention, kan_state=None):
    """The skeleton's keys; ``self_attention(h, q, sa, sa_stats, sa_kan)``
    writes one block's scan layer (params ``sa``, batch stats ``sa_stats``
    and KAN state ``sa_kan``, each None where it has none) under the prefix
    ``q`` through the helpers ``h``."""
    sd: Dict[str, torch.Tensor] = {}
    kan_state = kan_state or {}
    h = _writer(sd)
    put, conv, ln, bn = h["put"], h["conv"], h["ln"], h["bn"]
    if "conv_t_conv" in params:
        stem = params["conv_t_conv"]
        bn("conv_T_conv.bn", stem["bn"], batch_stats["conv_t_conv"]["bn"])
        conv("conv_T_conv.conv1", stem["conv1"])
        conv("conv_T_conv.conv2", stem["conv2"])
        conv("conv_T_conv.PW_conv", stem["pw"])
    conv("patch_embed.proj", params["patch_embed"]["proj"])
    ln("patch_embed.norm", params["patch_embed"]["norm"])
    if "mifa" in params:
        mifa = params["mifa"]
        for name in ("dw", "pw", "merge"):
            conv("mifa." + name, mifa[name])
        put("mifa.eca.conv.weight",
            np.asarray(mifa["eca"]["conv"]["kernel"]).transpose(2, 1, 0))
    for i in range(_count(params, "layers_")):
        layer = params[f"layers_{i}"]
        stats = batch_stats[f"layers_{i}"]
        layer_kan = kan_state.get(f"layers_{i}", {})
        for j in range(_count(layer, "blocks_")):
            _ssconv_block(h, f"layers.{i}.blocks.{j}", layer[f"blocks_{j}"],
                          stats[f"blocks_{j}"], self_attention,
                          layer_kan.get(f"blocks_{j}", {}).get(
                              "self_attention"))
        if "downsample" in layer:
            _merging(h, f"layers.{i}.downsample", layer["downsample"])
    _head(h, params["classifier"], batch_stats.get("classifier", {}),
          kan_state.get("classifier", {}))
    return sd


def _head(h, p, s, k):
    """The classifier head under the reference's names: ``head`` (linear),
    ``kan`` (ekan, okan: the JAX module's ``head``), ``kan1``-``kan3``
    (kan_stack), ``kans`` (kan_module, 3kan, with its BatchNorm)."""
    if "kernel" in p.get("head", {}):
        h["dense"]("head", p["head"])
    elif "head" in p:
        h["kan"]("kan", p["head"], k["head"])
    elif "kans" in p:
        kans = p["kans"]
        for name in kans:
            if name != "bn":
                h["kan"]("kans." + name, kans[name], k["kans"][name])
        h["bn"]("kans.bn", kans["bn"], s["kans"]["bn"])
    else:
        for name in p:
            h["kan"](name, p[name], k[name])


def _ss2d(h, q, sa, sa_stats, sa_kan):
    h["dense"](q + ".in_proj", sa["in_proj"])
    h["conv"](q + ".conv2d", sa["conv2d"])
    for name in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias"):
        h["put"](f"{q}.{name}", sa[name])
    A = np.asarray(sa["A_logs"])
    h["put"](q + ".A_logs", A.reshape(-1, A.shape[-1]))
    h["put"](q + ".Ds", np.asarray(sa["Ds"]).reshape(-1))
    h["ln"](q + ".out_norm", sa["out_norm"])
    h["dense"](q + ".out_proj", sa["out_proj"])


def _ss2d_ssd(h, q, sa, sa_stats, sa_kan):
    put = h["put"]
    for name in ("filter_kan", "in_proj_kan"):
        if name in sa:
            h["kan"](f"{q}.{name}", sa[name], sa_kan[name])
    if "in_proj" in sa:
        h["dense"](q + ".in_proj", sa["in_proj"])
    h["conv"](q + ".conv2d", sa["conv2d"])
    put(q + ".dt_bias", sa["dt_bias"])
    put(q + ".A_logs", np.asarray(sa["A_logs"]).reshape(-1))
    put(q + ".Ds", np.asarray(sa["Ds"]).reshape(-1))
    put(q + ".norm.weight", sa["norm_weight"])
    h["dense"](q + ".out_proj", sa["out_proj"])
    if "stl" not in sa:
        return
    for mod, names in (("stl", ("u1", "u2")), ("stf", ("z",))):
        for name in names:
            put(f"{q}.{mod}.learnable_{name}", sa[mod][name])
        mix = sa[mod]["mix"]                      # Dense(2 -> 1)
        put(f"{q}.{mod}.conv1d.weight",
            np.asarray(mix["kernel"]).T[:, :, None])
        put(f"{q}.{mod}.conv1d.bias", mix["bias"])
    h["bn"](q + ".o_norm", sa["o_norm"], sa_stats["o_norm"])
    h["conv"](q + ".o_linear", sa["o_linear"])
    put(q + ".k_weights", sa["k_weights"])


def medmamba_state_dict_from_jax(params, batch_stats) -> Dict[str,
                                                              torch.Tensor]:
    """JAX MedMamba (params, batch_stats) -> the port's ``state_dict``."""
    return _vssm_state_dict(params, batch_stats, _ss2d)


def medssd_state_dict_from_jax(params, batch_stats, kan_state=None
                               ) -> Dict[str, torch.Tensor]:
    """JAX MedSSD-family (params, batch_stats, kan_state) -> the port's
    ``state_dict``: MedSSD, ST-SSD (the ST tail wherever a block's params
    have one), CNN-Mamba (the stem and MIFA wherever the params have them)
    and the KAN models (their ``kan_state`` buffers beside the
    parameters)."""
    return _vssm_state_dict(params, batch_stats, _ss2d_ssd, kan_state)


st_ssd_state_dict_from_jax = medssd_state_dict_from_jax


def _crossmamba(h, q, p):
    """A CrossMamba core (``_crossmamba`` of the JAX importer, inverted)."""
    for name in ("skip_in_proj", "xs_in_proj", "BCdts_in_proj", "out_proj"):
        h["dense"](f"{q}.{name}", p[name])
    for name in ("xs_conv2d", "BCdts_conv2d"):
        h["conv"](f"{q}.{name}", p[name])
    h["put"](q + ".dt_bias", p["dt_bias"])
    h["put"](q + ".A_logs", np.asarray(p["A_logs"]).reshape(-1))
    h["put"](q + ".Ds", np.asarray(p["Ds"]).reshape(-1))
    h["put"](q + ".norm.weight", p["norm_weight"])


def _expand(h, q, p):
    h["put"](q + ".expand.weight", np.asarray(p["expand"]["kernel"]).T)
    h["ln"](q + ".norm", p["norm"])


def _patch_embeds(h, params):
    for b in (1, 2):
        pe = params[f"patch_embed{b}"]
        h["conv"](f"patch_embed{b}.proj", pe["proj"])
        h["ln"](f"patch_embed{b}.norm", pe["norm"])


def _pair_blocks(h, q, lp, ls):
    """A U-Net stage's two block lists from the JAX package's scanned,
    vmapped pair: leaves [depth, 2, ...] -> ``{q}.blocks{b}.{j}``."""
    take = lambda t, j, b: {k: take(v, j, b) if hasattr(v, "items")
                            else np.asarray(v)[j, b] for k, v in t.items()}
    blk, stats = lp["blocks"]["block"], ls["blocks"]["block"]
    depth = np.shape(blk["ln_1"]["scale"])[0]
    for j in range(depth):
        for b in (1, 2):
            _ssconv_block(h, f"{q}.blocks{b}.{j}", take(blk, j, b - 1),
                          take(stats, j, b - 1), _ss2d_ssd)


def _fusion_stage(h, q, lp):
    """A stage's fusion, its cat_proj (with ``cat_method`` "stack") and its
    downsamples or upsamples and in_projs, wherever the stage has them."""
    _crossmamba(h, q + ".fusion", lp["fusion"])
    for name in ("cat_proj", "in_proj1", "in_proj2"):
        if name in lp:
            h["dense"](f"{q}.{name}", lp[name])
    for b in (1, 2):
        if f"downsample{b}" in lp:
            _merging(h, f"{q}.downsample{b}", lp[f"downsample{b}"])
        if f"upsample{b}" in lp:
            _expand(h, f"{q}.upsample{b}", lp[f"upsample{b}"])


def vfefm_state_dict_from_jax(params, batch_stats,
                              single_decoder: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``FusionVFEFM`` (params, batch_stats) -> the port's
    ``state_dict``: the exact inverse of ``import_vfefm_state_dict``, the
    scanned block pairs ([depth, 2, ...] leaves) unstacked into
    ``blocks1.{j}`` / ``blocks2.{j}``; ``single_decoder`` for ``_2c1``
    (one bridge Linear, single-stream decoder stages)."""
    sd: Dict[str, torch.Tensor] = {}
    h = _writer(sd)
    _patch_embeds(h, params)
    for i in range(_count(params, "layers_") - _count(params, "layers_up_")):
        lp, ls = params[f"layers_{i}"], batch_stats[f"layers_{i}"]
        _pair_blocks(h, f"layers.{i}", lp, ls)
        _fusion_stage(h, f"layers.{i}", lp)
    for j in range(_count(params, "layers_up_")):
        q = f"layers_up.{j}"
        lp, ls = params[f"layers_up_{j}"], batch_stats[f"layers_up_{j}"]
        if single_decoder:
            for k in range(_count(lp, "blocks_")):
                _ssconv_block(h, f"{q}.blocks.{k}", lp[f"blocks_{k}"],
                              ls[f"blocks_{k}"], _ss2d_ssd)
            if "upsample" in lp:
                _expand(h, q + ".upsample", lp["upsample"])
            for name in ("cat_down", "in_proj"):
                if name in lp:
                    h["dense"](f"{q}.{name}", lp[name])
        else:
            _pair_blocks(h, q, lp, ls)
            _fusion_stage(h, q, lp)
    if single_decoder:
        h["dense"]("bridge", params["bridge"])
    else:
        h["conv"]("bridge1", params["bridge1"])
        h["conv"]("bridge2", params["bridge2"])
        h["ln"]("norm", params["norm"])
        h["dense"]("final_cat_proj", params["final_cat_proj"])
    _expand(h, "final_expand", params["final_expand"])
    h["conv"]("final_conv", params["final_conv"])
    return sd


def cross_classifier_state_dict_from_jax(params, batch_stats,
                                         fuse_mode: str = "stage3"
                                         ) -> Dict[str, torch.Tensor]:
    """JAX ``CrossVSSMClassifier`` (params, batch_stats) -> the port's
    ``state_dict``: the exact inverse of
    ``import_cross_classifier_state_dict``.  The JAX blocks
    ``layers{b}_{i}_blocks_{j}`` go to ``layers{b}.{i}.blocks.{j}``
    ("stage3", "stage3_merged"; the merged fourth stage ``layers0_*`` to
    ``fused_layer.blocks.{j}``) or ``layers.{i}.blocks{b}.{j}`` ("all",
    with ``fusion_{i}``, ``cat_proj_{i}`` and ``down{b}_{i}`` under
    ``layers.{i}``); the stage downsamples ``down{b}_{i}`` of the stage3
    modes go to ``layers{b}.{i}.downsample``."""
    sd: Dict[str, torch.Tensor] = {}
    h = _writer(sd)
    _patch_embeds(h, params)
    every = fuse_mode == "all"
    for key in sorted(params):
        if not key.startswith("layers"):
            continue
        b, i, _, j = key[len("layers"):].split("_")
        q = ("fused_layer.blocks" if b == "0" else
             f"layers.{i}.blocks{b}" if every else f"layers{b}.{i}.blocks")
        _ssconv_block(h, f"{q}.{j}", params[key], batch_stats[key],
                      _ss2d_ssd)
    for key in sorted(params):
        if key.startswith("down") and key[4:5].isdigit():
            b, i = key[4:].split("_")
            q = (f"layers.{i}.downsample{b}" if every
                 else f"layers{b}.{i}.downsample")
            _merging(h, q, params[key])
    if every:
        for i in range(_count(params, "fusion_")):
            _crossmamba(h, f"layers.{i}.fusion", params[f"fusion_{i}"])
            if f"cat_proj_{i}" in params:
                h["dense"](f"layers.{i}.cat_proj", params[f"cat_proj_{i}"])
        h["dense"]("before_head_proj", params["before_head_proj"])
    else:
        _crossmamba(h, "fusion", params["fusion"])
        if "cat_proj" in params:
            h["dense"]("cat_proj", params["cat_proj"])
        for name in ("downsample", "downsample1", "downsample2"):
            if name in params:
                _merging(h, name, params[name])
    h["dense"]("head", params["head"])
    return sd


def mamba_lm_state_dict(params) -> Dict[str, torch.Tensor]:
    """JAX ``MambaLMHeadModel`` params -> the port's (and HF's) ``state_dict``:
    the exact inverse of ``utils/torch_import.py::import_mamba_lm_state_dict``
    (``backbone.`` prefixes, Dense kernels transposed, ``conv1d_weight``
    [d_conv, d_inner] -> ``conv1d.weight`` [d_inner, 1, d_conv],
    ``dt_proj_bias`` [1, d_inner] -> [d_inner]), plus the norms' LayerNorm
    biases where ``rms_norm`` is off and ``lm_head.weight``, the embedding
    itself (tied).  Also maps a gradient tree of the same structure."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def norm(prefix, p):
        put(prefix + ".weight", p["scale"])
        if "bias" in p:
            put(prefix + ".bias", p["bias"])

    def dense(prefix, p):
        put(prefix + ".weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            put(prefix + ".bias", p["bias"])

    put("backbone.embedding.weight", params["embedding"]["embedding"])
    for i in range(_count(params, "layers_")):
        layer = params[f"layers_{i}"]
        q = f"backbone.layers.{i}"
        norm(q + ".norm", layer["norm"])
        m = layer["mixer"]
        dense(q + ".mixer.in_proj", m["in_proj"])
        put(q + ".mixer.conv1d.weight",
            np.asarray(m["conv1d_weight"]).T[:, None, :])
        if "conv1d_bias" in m:
            put(q + ".mixer.conv1d.bias", m["conv1d_bias"])
        dense(q + ".mixer.x_proj", m["x_proj"])
        put(q + ".mixer.dt_proj.weight", m["dt_proj_weight"])
        put(q + ".mixer.dt_proj.bias", np.asarray(m["dt_proj_bias"])[0])
        put(q + ".mixer.A_log", m["A_log"])
        put(q + ".mixer.D", m["D"])
        dense(q + ".mixer.out_proj", m["out_proj"])
    norm("backbone.norm_f", params["norm_f"])
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    return sd
