"""Rank processes for the port's data-, sequence- and tensor-parallel
tests.

``spawn(task, world, tmp_path, payload)`` starts ``world`` CPU processes
(spawned, one thread each) that join a gloo process group through a
``file://`` rendezvous under ``tmp_path``, run ``TASKS[task]`` on
``payload`` and save what it returns; the caller gets the list, rank by
rank.  A rank that raises fails the spawn.  This module imports torch and
the port only (the children never import JAX); the test files hold the
ranks' results against the JAX package in the parent process.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def spawn(task, world, tmp_path, payload=None):
    tag = f"{task}_{world}_{len(os.listdir(tmp_path))}"
    pay = os.path.join(tmp_path, f"{tag}_payload.pt")
    torch.save(payload, pay)
    torch.multiprocessing.start_processes(
        _entry, args=(world, os.path.join(tmp_path, f"{tag}_rdv"), task, pay,
                      os.path.join(tmp_path, tag)),
        nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(tmp_path, f"{tag}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(rank, world, rdv, task, pay, out):
    import torch.distributed as dist

    from medical_image_classification_tpu_torch.parallel.mesh import (
        init_process_group)
    torch.set_num_threads(1)
    init_process_group("gloo", "cpu", rank=rank, world_size=world,
                       init_method="file://" + rdv)
    try:
        result = TASKS[task](rank, world, torch.load(pay, weights_only=False))
        torch.save(result, f"{out}_{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the mesh

def _mesh_checks(rank, world):
    """The groups of make_mesh at (sp 1), (sp 2) and (sp world): each
    axis's all-reduce of the ranks' ids; and the refusals."""
    from medical_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_)
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    out = {}
    for sp in sorted({1, 2, world}):
        mesh = make_mesh(sp=sp)
        got = {}
        for name in ("data", "seq"):
            axis = mesh.axis(name)
            t = torch.tensor([float(rank)])
            got[name] = (axis.size, axis.index, float(all_reduce_(t, axis)))
        out[sp] = got
    raised = []
    for kw in (dict(sp=3), dict(batch_size=world - 1)):
        try:
            make_mesh(**kw)
            raised.append(None)
        except ValueError as e:
            raised.append(str(e))
    set_current_mesh(None)
    return dict(groups=out, raised=raised)


# ---------------------------------------------------------------- the scans

def _odd_l_raises(rank, world):
    """A reduced medmamba and medssd with ``seq_axis`` at 28x28 (stage 0's
    L is 7^2 = 49) raise ValueError, and no sequence-parallel scan is
    called before."""
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.ops import ss2d
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    make_mesh(sp=world)
    calls = []
    saved = (ss2d.scan_sequence_parallel, ss2d.ssd_scan_sequence_parallel)
    ss2d.scan_sequence_parallel = lambda *a, **k: calls.append("scan")
    ss2d.ssd_scan_sequence_parallel = lambda *a, **k: calls.append("ssd")
    msgs = []
    try:
        for name, cfg in SP_MODELS.items():
            model = create_model(name, 3, seq_axis="seq", **cfg)
            try:
                model(torch.zeros(1, 28, 28, 3))
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
    finally:
        ss2d.scan_sequence_parallel, ss2d.ssd_scan_sequence_parallel = saved
        set_current_mesh(None)
    return dict(msgs=msgs, calls=calls)


# the reduced models of the JAX package's tests/test_sp_training.py:12-16
SP_MODELS = {
    "medmamba": dict(depths=(1, 1), dims=(8, 16), d_state=4,
                     drop_path_rate=0.0),
    "medssd": dict(depths=(1, 1), dims=(8, 16), d_state=4,
                   drop_path_rate=0.0, ssd_headdim=4)}


def scan_case(kind, inputs, weight, axis=None):
    """y and every input's gradient of sum(y * weight) for one scan case:
    ``kind`` "scan" (the folded Mamba-1 scan: u, delta, A, B, C, D, bias)
    or "ssd" (x, dt, A, B, C, D, dt_bias; chunk 8), L-sharded over
    ``axis``, or unsharded with ``axis`` None (the plain versions)."""
    from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (  # noqa: E501
        scan_folded_fwd)
    from medical_image_classification_tpu_torch.kernels.ssd import (
        ssd_chunked)
    from medical_image_classification_tpu_torch.parallel.sequence_parallel import (  # noqa: E501
        scan_sequence_parallel, ssd_scan_sequence_parallel)
    ts = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in inputs]
    if kind == "scan":
        y = (scan_folded_fwd(*ts, impl="torch") if axis is None else
             scan_sequence_parallel(*ts, axis, impl="torch"))
    else:
        x, dt, A, B, C, D, b = ts
        y = (ssd_chunked(x, dt, A, B, C, 8, D, b, impl="torch")
             if axis is None else
             ssd_scan_sequence_parallel(x, dt, A, B, C, 8, D, b, axis,
                                        impl="torch"))
    (y * torch.from_numpy(weight)).sum().backward()
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


def _scans(rank, world, payload):
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    out = dict(mesh=_mesh_checks(rank, world),
               odd=_odd_l_raises(rank, world))
    axis = make_mesh(sp=world).axis("seq")
    out["cases"] = [scan_case(c["kind"], c["inputs"], c["weight"], axis)
                    for c in payload]
    set_current_mesh(None)
    return out


# ---------------------------------------------------------------- a step

@contextlib.contextmanager
def recorded_masks():
    """The DropPath masks drawn inside the block, in order."""
    from medical_image_classification_tpu_torch.models.common import DropPath
    orig, masks = DropPath.mask, []

    def mask(self, x):
        m = orig(self, x)
        if m is not None:
            masks.append(m.detach().clone())
        return m

    DropPath.mask = mask
    try:
        yield masks
    finally:
        DropPath.mask = orig


def run_step(p, rank=0, dp=1, mesh=None):
    """One train step of ``p['name']`` (create_model kwargs ``p['cfg']``,
    weights ``p['sd']``) on this rank's rows (rank::dp) of the global batch
    ``p['images']`` / ``p['labels']``, by ``make_train_step`` with
    ``p['opt']`` at ``p['lr']`` (and ``p['clip']``'s global-norm clip),
    DropPath seeded ``p.get('seed', 1)``.  Returns the metrics, the
    logits, every parameter's gradient and the state_dict after the step,
    and the DropPath masks drawn.  Under tensor parallelism (``mesh`` with
    tp > 1, ``p['cfg']`` naming the model axis) the rank loads its pieces
    of ``p['sd']`` and the gradients and the state_dict come back joined
    over the model axis: the full ones."""
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.parallel.sharding import (
        gather_state_dict, shard_state_dict)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState, make_train_step)
    tp = mesh is not None and mesh.tp > 1
    model = create_model(p["name"], p["classes"], **p["cfg"])
    model.load_state_dict(shard_state_dict(p["sd"], mesh) if tp else p["sd"],
                          strict=True)
    model.seed_drop_path(p.get("seed", 1))
    opt = make_optimizer(p["opt"], model.named_parameters(),
                         grad_clip=p.get("clip"))
    sched = make_lr_scheduler(opt, make_schedule("constant", p["lr"]))
    step = make_train_step(model, opt, sched, state=TrainState())
    imgs = torch.from_numpy(p["images"][rank::dp])
    labels = torch.from_numpy(p["labels"][rank::dp]).long()
    logits = []
    hook = model.register_forward_hook(
        lambda m, args, out: logits.append(out.detach().clone()))
    with recorded_masks() as masks:
        m = step(imgs, labels)
    hook.remove()
    grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()
             if q.grad is not None}
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if tp:
        grads, sd = gather_state_dict(grads, mesh), gather_state_dict(sd, mesh)
    return dict(loss=float(m["loss"]), accuracy=float(m["accuracy"]),
                logits=logits[0], grads=grads, sd=sd, masks=masks)


def _step(rank, world, p):
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    mesh = make_mesh(tp=p.get("tp", 1), sp=p.get("sp", 1),
                     batch_size=len(p["labels"]))
    try:
        return run_step(p, mesh.data_index, mesh.dp, mesh)
    finally:
        set_current_mesh(None)


def _steps(rank, world, ps):
    """``_step`` of each payload of ``ps`` in turn (one spawn, several
    models or meshes)."""
    return [_step(rank, world, p) for p in ps]


# ---------------------------------------------------------------- KAN

def run_regrid(p, rank=0, dp=1):
    """kan_grid_update of ``p['name']`` on this rank's rows of
    ``p['images']``; returns the state_dict after it."""
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.train.train_step import (
        kan_grid_update)
    model = create_model(p["name"], p["classes"], **p["cfg"])
    model.load_state_dict(p["sd"], strict=True)
    kan_grid_update(model, torch.from_numpy(p["images"][rank::dp]))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _regrid(rank, world, p):
    from medical_image_classification_tpu_torch.parallel.mesh import (
        make_mesh, set_current_mesh)
    mesh = make_mesh(batch_size=len(p["images"]))
    try:
        return run_regrid(p, mesh.data_index, mesh.dp)
    finally:
        set_current_mesh(None)


# ---------------------------------------------------------------- the CLI

def tiny_registry(name, overrides):
    """Put a tiny ``name`` in the port's registry (create_model's kwargs
    ``overrides`` win)."""
    from medical_image_classification_tpu_torch.models import registry
    orig = registry._REGISTRY[name]

    def tiny(num_classes, **kw):
        kw.update(overrides)
        return orig(num_classes, **kw)

    registry._REGISTRY[name] = tiny


def _cli(rank, world, p):
    from medical_image_classification_tpu_torch.cli import ddp_train
    tiny_registry(p["name"], p["cfg"])
    ddp_train.main(ddp_train.parse_args(p["argv"]))
    return None


TASKS = dict(scans=_scans, step=_step, steps=_steps, regrid=_regrid,
             cli=_cli)
