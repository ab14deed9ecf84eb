"""Tensor parallelism's parameter layout over the mesh's 'model' axis.

Port of ``medical_image_classification_tpu/parallel/sharding.py``.  The
JAX package gives GSPMD one PartitionSpec a parameter (``_spec_for``) and
lets it place the collectives; GSPMD splits a leaf into contiguous pieces
and computes exactly the unsharded function.  Here each SS2D / SS2DSSD
layer holds its rank's channels (or heads) as tensors of local width and
runs its own collectives (``models/ss2d_modules.py``), so a rule says
which dimension of a ``state_dict`` entry splits and into which blocks:
a leaf that concatenates several quantities splits each block alone.
Everything outside the layers' ``self_attention`` is replicated, as in
the JAX rules, and the full ``state_dict`` is the unsharded model's, so
every carrier and checkpoint stays as it is.

SS2D (Mamba-1, d_inner D, K = 4 directions) under ``<p>`` = a block's
``self_attention.``:

  in_proj.weight       [2D, d_model]    rows [x | z], each split
  conv2d.weight, .bias [D, ...]         split (depthwise)
  x_proj_weight        [K, R + 2N, D]   dim 2
  dt_projs_weight      [K, D, R]        dim 1
  dt_projs_bias        [K, D]           dim 1
  A_logs, Ds           [K D, ...]       K blocks, each split
  out_norm.weight, .bias [D]            split (the statistics span D)
  out_proj.weight      [d_model, D]     dim 1 (row-parallel)

SS2DSSD (d_ssm, H heads, one B/C group of d_state N):

  in_proj.weight       [2 d_ssm + 2N + H, d_model]  rows [z | x | B | C |
                                        dt]: z, x and dt split by head,
                                        B and C replicated
  conv2d.weight, .bias [d_ssm + 2N + H, ...]  [x | B | C | dt], the same
  dt_bias              [K, H]           dim 1
  A_logs, Ds           [K H]            K blocks, each split
  norm.weight          [d_ssm]          split (rmsnorm over all d_ssm)
  out_proj.weight      [d_model, d_ssm] dim 1 (row-parallel)

A contiguous split of the SSD concatenations, as GSPMD makes, would cut
through B and C.  The layers' other parameters stay replicated: the
ST-SSD tail (``stl``, ``stf``, ``o_norm``, ``o_linear``, ``k_weights``),
``in_proj_kan`` and ``filter_kan``.  Every rank computes the replicated
blocks of B and C, the tail and ``in_proj_kan`` inside the layer's region
and feeds its own heads with them, so each rank's gradient of those
parameters is its share: ``redundant_grads`` lists them, and the train
step sums them over 'model' (``train/train_step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import torch

from medical_image_classification_tpu_torch.parallel.collectives import (
    all_gather,
)

K = 4  # scan directions

_SA = "self_attention."
# the SS2DSSD children computed redundantly inside the layer's region
_REDUNDANT = ("stl.", "stf.", "o_norm.", "o_linear.", "k_weights",
              "in_proj_kan.")


@dataclasses.dataclass(frozen=True)
class Split:
    """How one leaf splits: along ``dim``, block by block; each block is
    (full width, split over the axis or replicated).  ``rule`` names the
    rule."""
    rule: str
    dim: int
    blocks: Tuple[Tuple[int, bool], ...]

    def local_blocks(self, tp: int):
        """(start, width, split) of each block in a rank's local leaf."""
        at = 0
        for width, split in self.blocks:
            w = width // tp if split else width
            yield at, w, split
            at += w

    def piece(self, full: torch.Tensor, tp: int, index: int) -> torch.Tensor:
        """Rank ``index``'s leaf (a new tensor) of the full ``full``."""
        parts, at = [], 0
        for width, split in self.blocks:
            w = width // tp if split else width
            parts.append(full.narrow(self.dim, at + (index * w if split
                                                     else 0), w))
            at += width
        return torch.cat(parts, self.dim)

    def join(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """The full leaf from every rank's, in rank order (a replicated
        block from the first)."""
        parts = []
        for at, w, split in self.local_blocks(len(pieces)):
            parts += [p.narrow(self.dim, at, w)
                      for p in (pieces if split else pieces[:1])]
        return torch.cat(parts, self.dim)


def _ss2d(p: str, D: int) -> Dict[str, Split]:
    s = ((D, True),)
    return {p + "in_proj.weight": Split("ss2d in_proj [x|z]", 0, s + s),
            p + "conv2d.weight": Split("ss2d conv2d", 0, s),
            p + "conv2d.bias": Split("ss2d conv2d", 0, s),
            p + "x_proj_weight": Split("ss2d x_proj", 2, s),
            p + "dt_projs_weight": Split("ss2d dt_projs", 1, s),
            p + "dt_projs_bias": Split("ss2d dt_projs", 1, s),
            p + "A_logs": Split("ss2d per direction", 0, s * K),
            p + "Ds": Split("ss2d per direction", 0, s * K),
            p + "out_norm.weight": Split("ss2d out_norm", 0, s),
            p + "out_norm.bias": Split("ss2d out_norm", 0, s),
            p + "out_proj.weight": Split("ss2d out_proj rows", 1, s)}


def _ssd(p: str, d_ssm: int, H: int, N: int) -> Dict[str, Split]:
    x, h, bc = (d_ssm, True), (H, True), ((N, False), (N, False))
    conv = (x,) + bc + (h,)
    return {p + "in_proj.weight": Split("ssd in_proj [z|x|B|C|dt]", 0,
                                        (x,) + conv),
            p + "conv2d.weight": Split("ssd conv2d [x|B|C|dt]", 0, conv),
            p + "conv2d.bias": Split("ssd conv2d [x|B|C|dt]", 0, conv),
            p + "dt_bias": Split("ssd per head", 1, (h,)),
            p + "A_logs": Split("ssd per direction", 0, (h,) * K),
            p + "Ds": Split("ssd per direction", 0, (h,) * K),
            p + "norm.weight": Split("ssd norm", 0, (x,)),
            p + "out_proj.weight": Split("ssd out_proj rows", 1, (x,))}


def ssd_in_proj_split(d_ssm: int, H: int, N: int, dim: int = 0) -> Split:
    """The blocks of an SS2DSSD's ``[z | x | B | C | dt]`` projection along
    ``dim``: its ``in_proj`` rows (0), or ``in_proj_kan``'s output
    channels (-1)."""
    return dataclasses.replace(_ssd("", d_ssm, H, N)["in_proj.weight"],
                               dim=dim)


def split_rules(shapes: Mapping[str, Sequence[int]], tp: int = 1,
                local: bool = False) -> Dict[str, Split]:
    """The rule of every split leaf among ``shapes`` ({state_dict or
    parameter name: shape}) of a full model, or with ``local`` of one
    rank's of ``tp``; the full widths in either case.  Raises
    ``ValueError`` where ``tp`` does not divide a layer's d_inner or
    heads."""
    s = tp if local else 1
    rules: Dict[str, Split] = {}
    for key in shapes:
        if key.endswith(_SA + "x_proj_weight"):
            p = key[:-len("x_proj_weight")]
            rules.update(_ss2d(p, shapes[p + "conv2d.weight"][0] * s))
        elif key.endswith(_SA + "dt_bias"):
            p = key[:-len("dt_bias")]
            d_ssm, H = shapes[p + "norm.weight"][0], shapes[p + "dt_bias"][1]
            N = (shapes[p + "conv2d.weight"][0] - d_ssm - H) // 2
            rules.update(_ssd(p, d_ssm * s, H * s, N))
    for key, rule in rules.items():
        for width, split in rule.blocks:
            if split and width % tp:
                raise ValueError(
                    f"tensor parallelism over {tp} ranks: {key} splits a "
                    f"block of {width}, which {tp} does not divide")
    return {k: r for k, r in rules.items() if k in shapes}


def _shapes(tensors: Mapping[str, torch.Tensor]):
    return {k: tuple(t.shape) for k, t in tensors.items()}


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh
                     ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the rank ``mesh.model_index`` of ``mesh.tp``
    from the full one: its piece of every split leaf, every other entry
    as it is."""
    rules = split_rules(_shapes(full), mesh.tp)
    if mesh.tp == 1:
        return dict(full)
    return {k: rules[k].piece(t, mesh.tp, mesh.model_index) if k in rules
            else t for k, t in full.items()}


def _join(pieces: Sequence[Mapping], rules):
    """The full tensors from every rank's (``pieces``, in rank order):
    each split one joined by its rule, the others rank 0's."""
    return {k: rules[k].join([p[k] for p in pieces]) if k in rules else t
            for k, t in pieces[0].items()}


def join_state_dicts(pieces: Sequence[Mapping[str, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from every 'model' rank's, in rank order
    (what ``gather_state_dict`` assembles after its all-gather)."""
    return _join(pieces, split_rules(_shapes(pieces[0]), len(pieces),
                                     local=True))


def _gather(tensors: Mapping, rules, axis):
    """Every split tensor of ``tensors`` joined over ``axis`` (one
    all-gather a dtype), the others as they are."""
    pieces = [dict(tensors) for _ in range(axis.size)]
    keys = [k for k in tensors if k in rules]
    for dtype in {tensors[k].dtype for k in keys}:
        ks = [k for k in keys if tensors[k].dtype == dtype]
        stack = all_gather(torch.cat([tensors[k].reshape(-1) for k in ks]),
                           axis)
        at = 0
        for k in ks:
            t = tensors[k]
            for r, piece in enumerate(pieces):
                piece[k] = stack[r, at:at + t.numel()].view_as(t)
            at += t.numel()
    return _join(pieces, rules)


def gather_state_dict(local: Mapping[str, torch.Tensor], mesh
                      ) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from every 'model' rank's ``local`` (a
    collective over the axis: each rank of it calls, each gets the full
    dict)."""
    if mesh.tp == 1:
        return dict(local)
    return _gather(local, split_rules(_shapes(local), mesh.tp, local=True),
                   mesh.axis("model"))


def _moments(osd, names, shapes, rules, full: bool):
    """{(index, key): tensor} of every optimizer-state tensor of a split
    parameter that has the parameter's shape, the full one with ``full``
    (Adam's mu and nu, the other optimizers' traces), and their rules."""
    tensors, mrules = {}, {}
    for idx, st in osd["state"].items():
        rule = rules.get(names[idx])
        if rule is None:
            continue
        want = list(shapes[names[idx]])
        if full:
            want[rule.dim] = sum(w for w, _ in rule.blocks)
        for k, v in st.items():
            if torch.is_tensor(v) and list(v.shape) == want:
                tensors[idx, k], mrules[idx, k] = v, rule
    return tensors, mrules


def param_names(optimizer, model) -> List[str]:
    """The names of ``optimizer``'s parameters in its state_dict's order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _with_state(osd, tensors):
    state = {idx: dict(st) for idx, st in osd["state"].items()}
    for (idx, k), t in tensors.items():
        state[idx][k] = t
    return dict(osd, state=state)


def gather_optimizer_state(osd, optimizer, model, mesh):
    """``optimizer.state_dict()`` with the moments of every split parameter
    joined over 'model' (a collective, as ``gather_state_dict``)."""
    if mesh.tp == 1 or not osd["state"]:
        return osd
    shapes = _shapes(dict(model.named_parameters()))
    rules = split_rules(shapes, mesh.tp, local=True)
    tensors, mrules = _moments(osd, param_names(optimizer, model), shapes,
                               rules, False)
    return _with_state(osd, _gather(tensors, mrules, mesh.axis("model")))


def shard_optimizer_state(osd, optimizer, model, mesh):
    """A full optimizer state_dict (``gather_optimizer_state``'s) cut to
    this rank's moments, for ``optimizer.load_state_dict``."""
    if mesh.tp == 1 or not osd["state"]:
        return osd
    shapes = _shapes(dict(model.named_parameters()))
    rules = split_rules(shapes, mesh.tp, local=True)
    tensors, mrules = _moments(osd, param_names(optimizer, model), shapes,
                               rules, True)
    return _with_state(osd, {k: mrules[k].piece(t, mesh.tp, mesh.model_index)
                             for k, t in tensors.items()})


def redundant_grads(named_params: Iterable[Tuple[str, torch.Tensor]],
                    tp: int) -> List[Tuple[torch.Tensor, tuple]]:
    """(parameter, index) of every gradient piece that each 'model' rank
    holds only its share of: the replicated blocks of the split leaves
    (SS2DSSD's B and C rows and channels) and the whole leaves of the
    SS2DSSD children computed inside the region (``_REDUNDANT``).  The
    index is a tuple of slices into the parameter."""
    named = list(named_params)
    rules = split_rules(_shapes(dict(named)), tp, local=True)
    layers = [k[:-len("dt_bias")] for k in rules if k.endswith("dt_bias")]
    out = []
    for name, p in named:
        if name in rules:
            r = rules[name]
            out += [(p, (slice(None),) * r.dim + (slice(at, at + w),))
                    for at, w, split in r.local_blocks(tp) if not split]
        elif any(name.startswith(q + c) for q in layers for c in _REDUNDANT):
            out.append((p, (slice(None),)))
    return out


def split_sq_sums(t: torch.Tensor, rule, tp: int):
    """(sum of squares over the split blocks, over the replicated ones) of
    a rank's local tensor ``t`` under ``rule`` (None: all replicated), in
    fp32: the global square norm over the axis is the all-reduced first
    plus the second."""
    sq = t.float().square()
    if rule is None:
        return sq.new_zeros(()), sq.sum()
    split = rep = sq.new_zeros(())
    for at, w, is_split in rule.local_blocks(tp):
        part = sq.narrow(rule.dim, at, w).sum()
        if is_split:
            split = split + part
        else:
            rep = rep + part
    return split, rep
