"""Tensor parallelism of the SSD layers' replicated parts, over 2 gloo
ranks on the CPU.

A reduced st_ssd (the ST-SSD tail, which each rank runs on all d_ssm
channels gathered over the model axis and whose parameters stay
replicated; ``st_tokens``^2 equal to each stage's L at 32x32) and a
reduced kanin_ssd (the replicated ``in_proj_kan``, whose whole output
each rank computes and cuts to its blocks), the weights carried into
both packages: one tp-2 step with SGD at lr 1 against the JAX step on
``make_mesh(tp=2)``: the loss, the logits, the gradient of every leaf
joined over the ranks (the tail's, ``in_proj_kan``'s and the B/C blocks'
summed over the ranks' shares) and the BatchNorm running stats, at
``test_torch_parallel_tp.py``'s tolerances.  And a reduced kanout_ssd
(``filter_kan``, replicated in front of the region, whose gradient every
rank holds whole) against the port's one-process step, which
``test_torch_ssd16_models.py`` holds to JAX.  One spawn runs the three."""

import optax
import pytest
import torch

from medical_image_classification_tpu_torch.models import create_model
from test_torch_parallel_tp import (
    batch,
    check_against_jax,
    jax_step,
    jax_weights,
    payload,
)
from torch_parallel_workers import run_step, spawn

torch.set_num_threads(2)

CFGS = {
    # tests/test_torch_st_ssd.py's reduced st_ssd: 4 heads of 32 at stage 0
    "st_ssd": dict(depths=(1, 1), dims=(128, 256), d_state=16,
                   ssd_headdim=32, st_tokens=(8, 4), drop_path_rate=0.0),
    # tests/test_torch_ssd16_models.py's reduced kanin_ssd: 2 heads of 8
    "kanin_ssd": dict(depths=(1, 1), dims=(32, 64), ssd_headdim=8,
                      ssd_chunk_size=16, drop_path_rate=0.0)}
KANOUT = dict(CFGS["kanin_ssd"])


def test_st_tail_and_kan_in_proj_match_jax(tmp_path):
    images, labels = batch(1)
    ws = {name: jax_weights(name, cfg, seed=1) for name, cfg in CFGS.items()}
    ps = [payload(name, cfg, ws[name], images, labels)
          for name, cfg in CFGS.items()]
    # kanout_ssd: its seeded init with the biases and norms moved
    kanout = dict(ps[-1], name="kanout_ssd", cfg=dict(ps[-1]["cfg"]))
    gen = torch.Generator().manual_seed(6)
    kanout["sd"] = {
        k: v + 0.2 * torch.randn(v.shape, generator=gen)
        if k.endswith(("bias", "norm.weight", "dt_bias")) else v
        for k, v in create_model("kanout_ssd", 4, generator=torch.Generator()
                                 .manual_seed(5), **KANOUT)
        .state_dict().items()}
    ranks = spawn("steps", 2, tmp_path, ps + [kanout])
    for i, (name, cfg) in enumerate(CFGS.items()):
        j = jax_step(name, cfg, ws[name], images, labels, optax.sgd(1.0))
        for out in (ranks[0][i], ranks[1][i]):
            check_against_jax(out, j, name, ws[name])
        for k, t in ranks[1][i]["grads"].items():
            assert torch.equal(t, ranks[0][i]["grads"][k]), (name, k)
    one = run_step({**kanout, "cfg": KANOUT})
    assert any(".self_attention.filter_kan." in k for k in one["grads"])
    for out in (ranks[0][-1], ranks[1][-1]):
        assert out["loss"] == pytest.approx(one["loss"], rel=1e-6)
        for k, want in one["grads"].items():
            err = float((out["grads"][k] - want).double().norm())
            assert err <= 1e-7 or err <= 1e-4 * float(want.norm()), \
                (k, err, float(want.norm()))
