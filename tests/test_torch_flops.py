"""The port's ``utils/flops.py`` on the CPU: ``selective_scan_flops`` and
``ssd_flops`` against the JAX package's over one grid; each forward op's
formula and each backward's against an independent count of the same
function's products from the shapes, and FlopCounterMode counting exactly
those through the autograd Functions (the forward op, the backward op,
nothing of the plain twins); ``model_flops`` of a
reduced medmamba against the JAX model's ``dot_general`` and
``conv_general_dilated`` FLOPs read from ``jax.make_jaxpr`` (nothing
compiled; the JAX flip-free path, as the port's) plus the scan formula over
the same calls; the same count on a real CPU run and under FakeTensorMode
for reduced medmamba, medssd and st_ssd, forward and train step (the
port's train step, Adam included); ``cost_analysis``; and the FLOP report
script at a tiny size."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import medical_image_classification_tpu.kernels.selective_scan_pallas as ssp
import medical_image_classification_tpu.kernels.selective_scan_pallas_v2 as v2
from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.utils import flops as jflops
from medical_image_classification_tpu_torch.data.image_folder import (
    normalize_batch,
)
from medical_image_classification_tpu_torch.kernels import (
    selective_scan_bwd as ssb,
    ssd as tssd,
    ssd_fused as sf,
    ssd_fused_dirs as sfd,
    ssd_ydiag as yd,
    stf_zgate as stf,
    stl_mixer as stl,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    make_train_step,
)
from medical_image_classification_tpu_torch.utils import flops as tflops

torch.set_num_threads(1)


@pytest.mark.parametrize("B,L,D,N", [(1, 1, 1, 1), (2, 49, 96, 16),
                                     (32, 3136, 192, 16), (3, 7, 5, 64)])
def test_scan_models_equal_jax(B, L, D, N):
    for with_D in (True, False):
        for with_z in (True, False):
            assert tflops.selective_scan_flops(B, L, D, N, with_D, with_z) \
                == jflops.selective_scan_flops(B, L, D, N, with_D, with_z)
    for H, P, chunk in ((1, 1, 1), (8, 64, 224), (16, 64, 196),
                        (3, 5, 7)):
        assert tflops.ssd_flops(B, L * 4, H, P, N * 4, chunk) == \
            jflops.ssd_flops(B, L * 4, H, P, N * 4, chunk)


def _mm(m, n, k):
    """FLOPs of an [m, k] x [k, n] product."""
    return 2 * m * n * k


# Each hand kernel: (the autograd Function's inputs' shapes,
# how to apply it, the forward's products counted from the shapes: each
# (count, m, n, k), and the op's name).  The backward's products are each
# forward product's two cotangent products.
G, L, Dm, N = 6, 40, 16, 8                  # the scan: K 2 directions
B, nc, l, H4, gn, P = 2, 3, 8, 8, 4, 8      # the dirs SSD
D_SSM = P * H4 // 4
BC, H = 6, 2                                # Y_diag, the fused SSD
BB, LL, C, PP = 2, 24, 16, 12               # the mixer and the gate
CASES = {
    "selective_scan": (
        [(G, L, Dm), (G, L, Dm), (2, Dm, N), (G, L, N), (G, L, N), (2, Dm),
         (2, Dm)],
        lambda *t: ssb.ScanFolded.apply(*t, False, True, "torch"),
        # the reference's accounting of the scan: 9 multiply-adds a state
        # step, and the D skip a channel step
        [(1, G * L * Dm, N, 9), (1, G * L, Dm, 1)],
        "selective_scan_fwd"),
    "ssd_fused_dirs": (
        [(B, nc, l, 2 * (D_SSM + 2 * gn + H4 // 4)),
         (B, nc, H4, l), (B, nc, H4, l), (B, nc, H4), (B, nc, H4, l),
         (H4,)],
        lambda *t: sfd.SSDFusedDirs.apply(*t, D_SSM, gn, "torch"),
        # per chunk and head: scores C B^T, Y_diag M x, the state B^T x,
        # Y_off C S (N the coupled 4 gn)
        [(B * nc * H4, l, l, 4 * gn), (B * nc * H4, l, P, l),
         (B * nc * H4, 4 * gn, P, l), (B * nc * H4, l, P, 4 * gn)],
        "ssd_fused_dirs_fwd"),
    "ssd_fused": (
        [(B, nc, l, N), (B, nc, l, N), (B, nc, H, l), (B, nc, H, l),
         (B, nc, H), (B, nc, H, l), (B, nc, l, H * P)],
        lambda *t: sf.SSDFused.apply(*t, "torch"),
        [(B * nc * H, l, l, N), (B * nc * H, l, P, l),
         (B * nc * H, N, P, l), (B * nc * H, l, P, N)],
        "ssd_fused_fwd"),
    "ssd_ydiag": (
        [(BC, l, N), (BC, l, N), (BC, H, l), (BC, H, l, P)],
        lambda *t: yd.YDiagFused.apply(*t, "torch"),
        [(BC * H, l, l, N), (BC * H, l, P, l)],
        "ssd_ydiag_fwd"),
    "stl_mixer": (
        [(BB, LL, C), (C, PP), (BB, LL, C)],
        lambda *t: stl.STLMixer.apply(*t, "torch"),
        [(BB, LL, PP, C), (BB, PP, C, LL)],            # S = w u1, U = E^T V
        "stl_mixer_fwd"),
    "stf_zgate": (
        [(BB, PP, C), (C, PP), (BB, PP, C)],
        lambda *t: stf.STFZGate.apply(*t, "torch"),
        [(BB, PP, PP, C), (BB, PP, C, PP)],            # pooledT lz, Z U
        "stf_zgate_fwd"),
}
def _fake_inputs(mode, shapes):
    return [mode.from_tensor(torch.zeros(s)).requires_grad_(True)
            for s in shapes]


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_and_backward_formulas(name):
    """The op's formula equals the products counted from the shapes, and
    FlopCounterMode over the Function's forward and backward counts the
    forward op once and the backward op (2 x the forward) once, nothing
    else; on fake inputs, so neither the kernel nor its twin runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    shapes, apply, products, op = CASES[name]
    want = sum(n * _mm(m, nn, k) for n, m, nn, k in products)
    with FakeTensorMode() as mode, FlopCounterMode(display=False) as c:
        ins = _fake_inputs(mode, shapes)
        y = apply(*ins)
        y = y[0] if isinstance(y, tuple) else y
        counts = {str(k): v for k, v in c.get_flop_counts()["Global"]
                  .items()}
        assert counts == {f"mic_torch.{op}": want}
        torch.autograd.grad(y.sum(), ins, allow_unused=True)
    counts = {str(k): v for k, v in c.get_flop_counts()["Global"].items()}
    bwd = op[:-len("fwd")] + "bwd"
    assert counts == {f"mic_torch.{op}": want, f"mic_torch.{bwd}": 2 * want}
    assert c.get_total_flops() == 3 * want


def _tiny(name):
    """The reduced models, with the kernel gates widened to them (the dirs
    SSD, Y_diag, the mixer and the gate take their ops)."""
    cfg = {"medmamba": dict(depths=(1, 1), dims=(16, 32), d_state=4),
           "medssd": dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                          d_state=32, ssd_headdim=8, ssd_chunk_size=16),
           "st_ssd": dict(depths=(1, 1), dims=(128, 256), d_state=16,
                          ssd_headdim=32, st_tokens=(8, 4))}[name]
    return create_model(name, 8, drop_path_rate=0.0,
                        generator=torch.Generator().manual_seed(0), **cfg)


@pytest.fixture
def widened(monkeypatch):
    monkeypatch.setattr(tssd, "_MIN_L", 8)
    monkeypatch.setattr(yd, "_MIN_L", 8)
    monkeypatch.setattr(stl, "_MIN_LP", 8 * 8)
    monkeypatch.setattr(stf, "_MIN_PP", 8 * 8)


@pytest.mark.parametrize("name", ["medmamba", "medssd", "st_ssd"])
def test_fake_and_real_counts_agree(widened, name):
    """model_flops (fake) against a real CPU forward under FlopCounterMode,
    and train_flops (fake) against a real CPU step through the port's
    train step (Adam, which counts nothing): equal, and the hand kernels'
    forward and backward ops in both."""
    from torch.utils.flop_counter import FlopCounterMode
    model = _tiny(name)
    imgs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    labels = torch.arange(2) % 8
    x = normalize_batch(imgs)
    fwd = tflops.model_flops(model, x)
    onehot = F.one_hot(labels, 8).float()
    step_fake = tflops.train_flops(
        model, x, lambda out, *a: -(onehot * F.log_softmax(out.float(), -1))
        .sum(-1).mean())
    model.eval()
    assert tflops.cost_analysis(lambda: model(x)) == {"flops": fwd}
    opt = make_optimizer("adam", model.named_parameters())
    step = make_train_step(model, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)))
    with FlopCounterMode(display=False) as c:
        step(imgs, labels)
    assert c.get_total_flops() == step_fake
    keys = {str(k) for k in c.get_flop_counts()["Global"]}
    ops = {"medmamba": ["selective_scan"],
           "medssd": ["ssd_fused_dirs", "ssd_ydiag"],
           "st_ssd": ["ssd_ydiag", "stl_mixer", "stf_zgate"]}[name]
    for op in ops:
        assert {f"mic_torch.{op}_fwd", f"mic_torch.{op}_bwd"} <= keys


def _jaxpr_flops(jaxpr):
    """(the dot_general and conv_general_dilated FLOPs of a jaxpr outside
    the scan's custom VJP calls, [each scan call's (u shape, A shape)]):
    a scan call is a custom_vjp_call whose body holds a pallas_call."""
    total, scans = 0, []

    def subs(e):
        for p in e.params.values():
            for q in (p if isinstance(p, (list, tuple)) else [p]):
                if hasattr(q, "jaxpr") and hasattr(q, "consts"):
                    yield q.jaxpr
                elif hasattr(q, "eqns"):
                    yield q

    def has_pallas(j):
        return any(e.primitive.name == "pallas_call" or any(
            has_pallas(s) for s in subs(e)) for e in j.eqns)

    def walk(j):
        nonlocal total
        for e in j.eqns:
            name = e.primitive.name
            out = math.prod(e.outvars[0].aval.shape)
            if name == "dot_general":
                (lc, _), _ = e.params["dimension_numbers"]
                lhs = e.invars[0].aval.shape
                total += 2 * out * math.prod(lhs[i] for i in lc)
            elif name == "conv_general_dilated":
                rhs = e.invars[1].aval.shape
                spec = e.params["dimension_numbers"].rhs_spec
                total += 2 * out * rhs[spec[1]] * math.prod(
                    rhs[i] for i in spec[2:])
            elif name.startswith("custom_vjp_call") and any(
                    has_pallas(s) for s in subs(e)):
                scans.append((e.invars[0].aval.shape, e.invars[2].aval.shape))
                continue
            for s in subs(e):
                walk(s)

    walk(jaxpr)
    return total, scans


@pytest.mark.parametrize("dims", [(64, 128), (16, 32)],
                         ids=["rank2-4", "rank1"])
def test_model_flops_equals_the_jax_jaxpr_count(monkeypatch, dims):
    """Reduced medmamba (depths 1-1) at 32x32, batch 2: the port's
    model_flops equals
    the JAX model's dot_general and conv_general_dilated FLOPs (its jaxpr,
    nothing compiled; the flip-free path with the folded Weff projection,
    as the port's, forced on as ``tests/test_torch_ss2d.py`` does) plus
    2 x selective_scan_flops over the same scan calls, less the known gap:
    at Δ rank 1 torch computes the Weff einsum ``rjqd,rjeq->rjde`` as a
    broadcast product, which FlopCounterMode does not count, where JAX
    counts a dot_general of 2 x 4 x d_inner² x 1 FLOPs a layer.  The SS2D
    of a medmamba block takes half the block's channels, so d_inner is the
    dim and the rank ceil(dim / 2 / 16): 1 at dims 16 and 32, 2 and 4 at
    64 and 128; full-size models have rank 3 and above."""
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    monkeypatch.setattr(v2, "_INTERPRET", True)
    monkeypatch.setattr(
        ssp, "pallas_folded_supported",
        lambda L, Dm, N: ssp._choose_tiles(L, Dm, N) is not None)
    cfg = dict(depths=(1, 1), dims=dims, d_state=4)
    gap = sum(2 * 4 * d ** 2 for d in dims if -(-(d // 2) // 16) == 1)
    jm = jax_create("medmamba", num_classes=8, drop_path_rate=0.0, **cfg)
    x = jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    jaxpr = jax.make_jaxpr(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, x).jaxpr
    dots, scans = _jaxpr_flops(jaxpr)
    assert len(scans) == 4 * 2                   # 4 directions, 2 blocks
    scan = sum(2 * jflops.selective_scan_flops(u[0], u[1], u[2], A[2])
               for u, A in scans)
    port = tflops.model_flops(create_model("medmamba", 8, **cfg),
                              torch.zeros(2, 32, 32, 3))
    assert port == dots + scan - gap
    assert (gap > 0) == (dims[0] == 16)


def test_cost_analysis_and_failure():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    assert tflops.cost_analysis(torch.matmul, a, b) == {"flops": 2 * 3 * 5 * 7}

    class Bad(torch.nn.Module):
        def forward(self, x):
            raise RuntimeError("no")

    assert tflops.model_flops(Bad(), torch.zeros(2)) is None
    assert tflops.train_flops(Bad(), torch.zeros(2), lambda o, x: o) is None


def test_flops_report_main_on_the_cpu(tmp_path, monkeypatch):
    """The report script's main() with --device cpu, one configuration,
    the model shrunk in the script's namespace: FLOPS.json's record keys,
    per-image values, written to --out only."""
    from medical_image_classification_tpu_torch.scripts import flops_report
    monkeypatch.setattr(flops_report, "create_model",
                        lambda name, n, **kw: _tiny(name))
    out = tmp_path / "f.json"
    args = flops_report.parse_args(["medmamba", "--device", "cpu", "--out",
                                    str(out)])
    got = flops_report.main(args)
    assert json.loads(out.read_text()) == got
    rec = got["medmamba"]
    assert set(rec) == {"model", "batch", "size", "dtype", "fwd_flops",
                        "step_flops", "fwd_flops_per_image",
                        "step_flops_per_image"}
    assert (rec["batch"], rec["size"], rec["dtype"]) == (32, 224, "bf16")
    assert rec["fwd_flops_per_image"] == rec["fwd_flops"] / 32
    assert rec["step_flops"] > 2 * rec["fwd_flops"] > 0
    assert set(flops_report.CONFIGS) == set(json.load(open(
        "FLOPS.json"))) | {"vfefm_2c1", "fusionmamba"}
