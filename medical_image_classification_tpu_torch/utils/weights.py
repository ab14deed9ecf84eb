"""Carry MedMamba, MedSSD, ST-SSD and Mamba-1 LM weights from the JAX
package to the port.

The reverse of ``medical_image_classification_tpu/utils/torch_import.py::
import_medmamba_state_dict`` and ``import_medssd_state_dict`` (with
``st_tokens=True`` for ST-SSD): the JAX
``params`` and ``batch_stats`` trees (nested dicts of numpy arrays) become
the port's ``state_dict``, ready for ``load_state_dict(strict=True)``.  The
port names its parameters as the reference ``state_dict`` does, so the JAX
importers map a port ``state_dict()`` back to the JAX trees.

Layouts: Dense kernel [in, out] -> Linear weight [out, in]; Conv HWIO ->
OIHW; MedMamba ``A_logs`` [K, d_inner, N] -> [K * d_inner, N] and ``Ds``
[K, d_inner] -> [K * d_inner]; MedSSD ``A_logs`` and ``Ds`` [K, nheads] ->
[K * nheads], ``dt_bias`` [K, nheads] as it is, ``norm_weight`` ->
``norm.weight``; ST-SSD's ``stl``/``stf`` ``u1``, ``u2``, ``z`` ->
``learnable_*`` and the Dense(2 -> 1) ``mix`` kernel [2, 1] -> the
``conv1d`` weight [1, 2, 1], ``o_norm`` with its batch stats, ``o_linear``
and ``k_weights``.  The Mamba LM (``mamba_lm_state_dict``) is the exact
inverse of ``import_mamba_lm_state_dict``, with the HF names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _count(tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _vssm_state_dict(params, batch_stats, self_attention):
    """The skeleton's keys; ``self_attention(h, q, sa, sa_stats)`` writes
    one block's scan layer (params ``sa``, batch stats ``sa_stats`` or
    None) under the prefix ``q`` through the helpers ``h``."""
    sd: Dict[str, torch.Tensor] = {}

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

    h = dict(put=put, dense=dense, conv=conv, ln=ln, bn=bn)
    conv("patch_embed.proj", params["patch_embed"]["proj"])
    ln("patch_embed.norm", params["patch_embed"]["norm"])
    for i in range(_count(params, "layers_")):
        layer = params[f"layers_{i}"]
        stats = batch_stats[f"layers_{i}"]
        for j in range(_count(layer, "blocks_")):
            blk = layer[f"blocks_{j}"]
            p = f"layers.{i}.blocks.{j}"
            ln(p + ".ln_1", blk["ln_1"])
            self_attention(h, p + ".self_attention", blk["self_attention"],
                           stats[f"blocks_{j}"].get("self_attention"))
            cb = blk["conv_branch"]
            cs = stats[f"blocks_{j}"]["conv_branch"]
            c = p + ".conv33conv33conv11"
            bn(c + ".0", cb["bn0"], cs["bn0"])
            conv(c + ".1", cb["conv1"])
            bn(c + ".2", cb["bn1"], cs["bn1"])
            conv(c + ".4", cb["conv2"])
            bn(c + ".5", cb["bn2"], cs["bn2"])
            conv(c + ".7", cb["conv3"])
        if "downsample" in layer:
            ln(f"layers.{i}.downsample.norm", layer["downsample"]["norm"])
            put(f"layers.{i}.downsample.reduction.weight",
                np.asarray(layer["downsample"]["reduction"]["kernel"]).T)
    dense("head", params["classifier"]["head"])
    return sd


def _ss2d(h, q, sa, sa_stats):
    h["dense"](q + ".in_proj", sa["in_proj"])
    h["conv"](q + ".conv2d", sa["conv2d"])
    for name in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias"):
        h["put"](f"{q}.{name}", sa[name])
    A = np.asarray(sa["A_logs"])
    h["put"](q + ".A_logs", A.reshape(-1, A.shape[-1]))
    h["put"](q + ".Ds", np.asarray(sa["Ds"]).reshape(-1))
    h["ln"](q + ".out_norm", sa["out_norm"])
    h["dense"](q + ".out_proj", sa["out_proj"])


def _ss2d_ssd(h, q, sa, sa_stats):
    put = h["put"]
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


def medssd_state_dict_from_jax(params, batch_stats) -> Dict[str,
                                                            torch.Tensor]:
    """JAX MedSSD or ST-SSD (params, batch_stats) -> the port's
    ``state_dict``."""
    return _vssm_state_dict(params, batch_stats, _ss2d_ssd)


# JAX ST-SSD (params, batch_stats) -> the port's ``state_dict``: the MedSSD
# carrier writes the ST tail wherever a block's params have one
st_ssd_state_dict_from_jax = medssd_state_dict_from_jax


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
