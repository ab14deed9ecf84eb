"""FLOP counts: the analytic scan models, and the port's own count of a
model's forward and train step.

Port of ``medical_image_classification_tpu/utils/flops.py``:
``selective_scan_flops`` and ``ssd_flops`` as they are (multiply-adds of
the reference's einsum accounting), and in place of ``xla_cost_analysis``
(XLA's count of a compiled program) ``cost_analysis``, built on
``torch.utils.flop_counter.FlopCounterMode``.  FLOPs are counted as
FlopCounterMode counts its products, two a multiply-add; elementwise
work, norms and the optimizer count nothing (XLA's count includes them).

The hand kernels are counted by formula (``kernels/flop_formulas.py``),
the same number on the CPU and on the card: each op ``mic_torch::*``,
forward and backward (``kernels/ops.py``), has its formula in
FlopCounterMode's registry, so the counter counts the op and not the plain
twin's aten ops inside it.  The scan's formula is 2 x
``selective_scan_flops``, the fused SSD's 2 x ``ssd_flops``, Y_diag's 2 x
``ssd_flops``' intra-chunk term, each backward 2 x its forward.

Counting runs on fake tensors (``FakeTensorMode``): no kernel runs and no
twin computes (each op's fake gives its outputs' shapes), so a full-size
model counts in seconds on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional


def selective_scan_flops(B: int, L: int, D: int, N: int, with_D: bool = True,
                         with_z: bool = False, with_group: bool = True) -> int:
    """MAC count of one selective-scan call (matches the reference's
    einsum-path accounting: 9·B·L·D·N core + tails)."""
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    if with_z:
        flops += B * D * L
    return flops


def ssd_flops(B: int, L: int, H: int, P: int, N: int, chunk: int) -> int:
    """Matmul MACs of the chunked SSD scan."""
    nc = -(-L // chunk)
    intra = B * nc * H * chunk * chunk * (N + P)      # scores + Y_diag
    states = B * nc * H * chunk * N * P               # state build
    off = B * nc * H * chunk * N * P                  # state consume
    return intra + states + off


# --------------------------------------------------------------------------
# counting a function, a model's forward, a train step


def cost_analysis(fn, *args) -> dict:
    """FLOPs of ``fn(*args)`` as FlopCounterMode counts them:
    {"flops": ...} (the counterpart of the JAX ``xla_cost_analysis``,
    which also gives bytes; this count has none)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@contextlib.contextmanager
def _fake(model, inputs, requires_grad=False):
    """Fake copies (FakeTensorMode, each on its tensor's device) of the
    model's parameters and buffers, by name, and of ``inputs``; inside the
    mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        state = {}
        for n, p in model.named_parameters():
            state[n] = mode.from_tensor(p.detach()).requires_grad_(
                requires_grad and p.requires_grad)
        for n, b in model.named_buffers():
            state[n] = mode.from_tensor(b)
        yield state, tuple(mode.from_tensor(t) for t in inputs)


def model_flops(model, sample_input) -> Optional[float]:
    """FLOPs of one forward pass (eval mode, no autograd) of ``model`` on
    ``sample_input`` (a tensor, or a tuple of the forward's tensors),
    counted on fake copies of its weights and inputs; None where counting
    fails, as the JAX version."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    was = model.training
    try:
        model.eval()
        with _fake(model, _as_tuple(sample_input)) as (state, args), \
                torch.no_grad(), FlopCounterMode(display=False) as counter:
            torch.func.functional_call(model, state, args)
        return float(counter.get_total_flops())
    except Exception:
        return None
    finally:
        model.train(was)


def train_flops(model, inputs, loss_fn) -> Optional[float]:
    """FLOPs of one train step's forward (train mode) and backward of
    ``loss_fn(model(*inputs), *inputs)`` for every parameter, counted on
    fake copies as ``model_flops``; the optimizer's update counts nothing.
    None where counting fails."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    was = model.training
    try:
        model.train()
        with _fake(model, _as_tuple(inputs), requires_grad=True) as (
                state, args), FlopCounterMode(display=False) as counter:
            out = torch.func.functional_call(model, state, args)
            params = [state[n] for n, p in model.named_parameters()
                      if p.requires_grad]
            torch.autograd.grad(loss_fn(out, *args), params,
                                allow_unused=True)
        return float(counter.get_total_flops())
    except Exception:
        return None
    finally:
        model.train(was)
