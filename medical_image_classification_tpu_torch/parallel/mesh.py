"""The process groups of parallel training: the mesh.

Port of ``medical_image_classification_tpu/parallel/mesh.py``.  The JAX
package lays its devices out on a ``jax.sharding.Mesh`` with the axes
('data', 'model', 'seq'); here each rank is one process (torchrun's
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, or explicit arguments) and each
axis is a set of ``torch.distributed`` groups over the ranks laid out in
the JAX array's order, rank = (d * tp + m) * sp + s:

  'data'  — data parallelism: the ranks with the same (m, s).  Gradients
            are averaged over it (``train/train_step.py``), BatchNorm sums
            its statistics over it and DropPath draws the global batch's
            masks (``models/common.py``).
  'seq'   — sequence parallelism: the ranks with the same (d, m).  The
            SS2D scans are L-sharded over it
            (``parallel/sequence_parallel.py``); everything else is
            replicated, and every seq rank holds the full gradients.
  'model' — tensor parallelism: the ranks with the same (d, s).  Each
            SS2D / SS2DSSD layer holds its rank's channels (or heads) of
            the d_inner-wide parameters (``parallel/sharding.py``), its
            in- and out-projections column- and row-parallel; everything
            outside the layers is replicated.

Two differences from the JAX package.  A rank cannot sit out a
collective, so where ``batch_size`` shrinks the data axis and leaves ranks
outside the mesh, ``make_mesh`` raises.  And the backend is the caller's
choice (``init_process_group``): NCCL on ``cuda:LOCAL_RANK`` by default,
one rank a GPU; gloo where the caller names it (CPU processes, or ranks
that share one card).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model", "seq")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its group (None when the axis
    has one rank: nothing to communicate), its size and this rank's index
    along it."""
    group: object
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, tp, sp) layout of the job's ranks and this rank's groups."""
    dp: int
    tp: int
    sp: int
    rank: int
    data_group: object = None
    seq_group: object = None
    model_group: object = None

    @property
    def shape(self):
        return dict(zip(AXES, (self.dp, self.tp, self.sp)))

    @property
    def data_index(self) -> int:
        return self.rank // (self.tp * self.sp)

    @property
    def model_index(self) -> int:
        return (self.rank // self.sp) % self.tp

    @property
    def seq_index(self) -> int:
        return self.rank % self.sp

    def axis(self, name: str) -> Axis:
        if name == "data":
            return Axis(self.data_group, self.dp, self.data_index)
        if name == "model":
            return Axis(self.model_group, self.tp, self.model_index)
        if name == "seq":
            return Axis(self.seq_group, self.sp, self.seq_index)
        raise ValueError(f"unknown mesh axis {name!r}; the mesh has {AXES}")


def mesh_shape(world: int, tp: int = 1, sp: int = 1,
               batch_size: Optional[int] = None) -> Tuple[int, int, int]:
    """(dp, tp, sp) by the JAX ``make_mesh``'s arithmetic: ``world`` must
    divide by tp * sp, dp = world // (tp * sp), shrunk until it divides
    ``batch_size``."""
    if world % (tp * sp):
        raise ValueError(f"{world} ranks not divisible by tp*sp={tp * sp} "
                         f"(a multiple of {tp * sp} ranks needed, {world} "
                         f"given)")
    dp = world // (tp * sp)
    if batch_size is not None:
        while dp > 1 and batch_size % dp:
            dp -= 1
    return dp, tp, sp


def _group(ranks):
    # every rank creates every group, in the same order (new_group is
    # collective over the whole job), and keeps those it belongs to
    return dist.new_group(list(ranks)) if len(ranks) > 1 else None


def make_mesh(tp: int = 1, sp: int = 1,
              batch_size: Optional[int] = None) -> Mesh:
    """The mesh over the job's ranks (one rank without a process group),
    registered as the current mesh.  Raises ``ValueError`` where the ranks
    do not divide by tp * sp, and where ``batch_size`` shrinks the data
    axis so far that some ranks lie outside the mesh: in the JAX package
    those devices stay idle, here every rank must take part in every
    collective of its groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp, tp, sp = mesh_shape(world, tp, sp, batch_size)
    if dp * tp * sp != world:
        raise ValueError(
            f"batch size {batch_size} shrinks the data axis to {dp}, which "
            f"leaves {world - dp * tp * sp} of the {world} ranks outside the "
            f"(dp {dp}, tp {tp}, sp {sp}) mesh; give a batch size divisible "
            f"by {world // (tp * sp)} or launch fewer ranks")
    data_group = model_group = seq_group = None
    at = lambda d, m, s: (d * tp + m) * sp + s
    for m in range(tp):
        for s in range(sp):
            ranks = [at(d, m, s) for d in range(dp)]
            g = _group(ranks)
            if rank in ranks:
                data_group = g
    for d in range(dp):
        for s in range(sp):
            ranks = [at(d, m, s) for m in range(tp)]
            g = _group(ranks)
            if rank in ranks:
                model_group = g
    for d in range(dp):
        for m in range(tp):
            ranks = [at(d, m, s) for s in range(sp)]
            g = _group(ranks)
            if rank in ranks:
                seq_group = g
    mesh = Mesh(dp, tp, sp, rank, data_group, seq_group, model_group)
    set_current_mesh(mesh)
    return mesh


# the ambient mesh: the SP scans, the TP layers, BatchNorm, DropPath and
# the train step look it up here; trainers register it through
# make_mesh/set_current_mesh
_CURRENT_MESH: Optional[Mesh] = None


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


def data_axis() -> Optional[Axis]:
    """The current mesh's data axis where it spans more than one rank, else
    None (one process, or dp 1: the batch is the global batch)."""
    mesh = _CURRENT_MESH
    if mesh is None or mesh.dp == 1:
        return None
    return mesh.axis("data")


def mesh_axis(name: str) -> Axis:
    """The current mesh's axis ``name`` (a layer's ``seq_axis`` or
    ``model_axis``); raises where no mesh is registered."""
    if _CURRENT_MESH is None:
        raise ValueError(f"the mesh axis {name!r} needs a registered mesh "
                         "(parallel.mesh.make_mesh(tp=..., sp=...))")
    return _CURRENT_MESH.axis(name)


def rank_device(device: str, backend: str, local_rank: int) -> torch.device:
    """This rank's device: ``device`` as given where it names an index or
    the CPU; else the card ``local_rank`` (NCCL: one rank a GPU, more ranks
    than GPUs raise) or ``local_rank`` modulo the cards (gloo: ranks may
    share a card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"--device cpu needs --dist-backend gloo, not "
                             f"{backend!r}")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    if dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= n:
        raise ValueError(f"NCCL takes one rank a GPU: local rank "
                         f"{local_rank} of a host with {n} GPUs; launch "
                         f"fewer ranks or name --dist-backend gloo")
    return torch.device("cuda", local_rank % n)


def init_process_group(backend: str = "nccl", device: str = "cuda",
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> torch.device:
    """Join the job's process group and return this rank's device.

    The rank, world size and local rank come from the arguments or from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    rendezvous at ``MASTER_ADDR``:``MASTER_PORT`` unless ``init_method``
    says otherwise).  Without either (a plain ``python -m``), there is no
    process group and the device is ``device`` as given."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch sees no CUDA device")
        return dev
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown --dist-backend {backend!r} (nccl, gloo)")
    dev = rank_device(device, backend, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    return dev


def barrier() -> None:
    """Every rank waits here for the others (nothing in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def main_process_value(value: float, device) -> float:
    """Rank 0's ``value`` on every rank (one all-reduce over the job, on
    ``device``, where rank 0 alone writes); ``value`` in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    buf = torch.zeros(1, dtype=torch.float64, device=device)
    if dist.get_rank() == 0:
        buf += value
    dist.all_reduce(buf)
    return float(buf)
