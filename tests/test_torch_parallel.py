"""The port's mesh, loader shards and sequence-parallel scans against the
JAX package.

``make_mesh``'s arithmetic against JAX ``make_mesh`` (the data axis's
shrink, the tp*sp refusal) and the port's refusal to leave ranks outside
the mesh; the loader's shards against the JAX loader's; the L-sharded
Mamba-1 and SSD scans over 2 and 4 gloo ranks against the JAX functions
under ``shard_map`` on the 8 virtual CPU devices and against the
unsharded plain scans, y and every input's gradient; a reduced medmamba
and medssd at 28x28 (stage 0's L 49) raise under sequence parallelism in
both packages.  The ranks are spawned CPU processes
(``torch_parallel_workers.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.data.loader import (
    BatchLoader as JaxBatchLoader,
)
from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.ops import ss2d as jss2d
from medical_image_classification_tpu.parallel import mesh as jmesh
from medical_image_classification_tpu_torch.data.loader import BatchLoader
from medical_image_classification_tpu_torch.parallel.mesh import mesh_shape
from torch_parallel_workers import SP_MODELS, scan_case, spawn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_jax_mesh():
    yield
    jmesh.set_current_mesh(None)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_arithmetic_matches_jax(n):
    """(dp, tp, sp) of the port's ``mesh_shape`` equal the JAX mesh's
    shape over n devices, for tp 1-2, sp 1/2/4 and batch sizes that shrink
    the data axis; both refuse where n does not divide by tp * sp."""
    for tp in (1, 2):
        for sp in (1, 2, 4):
            for bs in (None, 1, 2, 3, 4, 5, 6, 8, 12):
                try:
                    want = tuple(jmesh.make_mesh(
                        tp=tp, devices=jax.devices()[:n], batch_size=bs,
                        sp=sp).shape.values())
                except ValueError:
                    with pytest.raises(ValueError, match="not divisible"):
                        mesh_shape(n, tp, sp, bs)
                    continue
                assert mesh_shape(n, tp, sp, bs) == want, (n, tp, sp, bs)


class _Folder:
    def __init__(self, n):
        self.samples = [(f"{i}.png", i % 3) for i in range(n)]

    def __len__(self):
        return len(self.samples)


@pytest.mark.parametrize("n", [7, 10, 33])
@pytest.mark.parametrize("train", [True, False])
def test_loader_shards_match_jax(n, train):
    """Each shard's epoch indices and steps per epoch equal the JAX
    loader's; the shards are disjoint but for the wrap-around pad and
    together are the epoch, each rank's rows at index::count of the one
    process's order."""
    ds = _Folder(n)
    for count in (1, 2, 3, 4):
        got = []
        for index in range(count):
            kw = dict(train=train, seed=5, shard_index=index,
                      shard_count=count)
            port = BatchLoader(ds, 2, 32, **kw)
            want = JaxBatchLoader(ds, 2, 32, use_native=False, **kw)
            for epoch in (0, 3):
                np.testing.assert_array_equal(port._epoch_indices(epoch),
                                              want._epoch_indices(epoch))
            assert port.steps_per_epoch() == want.steps_per_epoch()
            got.append(port._epoch_indices(3))
        one = BatchLoader(ds, 2, 32, train=train, seed=5)._epoch_indices(3)
        per = -(-n // count)
        padded = np.concatenate([one, one[:per * count - n]])
        for index, idx in enumerate(got):
            np.testing.assert_array_equal(idx, padded[index::count])
        allx = np.concatenate(got)
        assert sorted(set(allx.tolist())) == list(range(n))
        assert len(allx) - len(set(allx.tolist())) == per * count - n


def _scan_inputs(rng):
    """Folded Mamba-1 scan operands: batch 2 x K 4 directions (G 8),
    L 32, Dm 6, N 4; and SSD operands: B 2, L 32, H 4, P 3, one group,
    N 5."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    G, L, Dm, N, K = 8, 32, 6, 4, 4
    scan = [f(G, L, Dm), 0.5 * f(G, L, Dm),
            (-0.5 - rng.random((K, Dm, N))).astype(np.float32),
            f(G, L, N), f(G, L, N), f(K, Dm), 0.1 * f(K, Dm)]
    Bz, H, P, Ns = 2, 4, 3, 5
    ssd = [f(Bz, L, H, P), 0.5 * f(Bz, L, H), (-0.5 - rng.random(H))
           .astype(np.float32), f(Bz, L, 1, Ns), f(Bz, L, 1, Ns), f(H),
           0.1 * f(H)]
    return [dict(kind="scan", inputs=scan, weight=f(G, L, Dm)),
            dict(kind="ssd", inputs=ssd, weight=f(Bz, L, H, P))]


def _jax_scan(case, n):
    """y and the input gradients of the JAX L-sharded scan (the shard_map
    of ``ops/ss2d.py``) over n devices, in the port's layouts."""
    jmesh.make_mesh(tp=1, sp=n, devices=jax.devices()[:n])
    ins = [jnp.asarray(a) for a in case["inputs"]]
    w = jnp.asarray(case["weight"])
    if case["kind"] == "scan":
        u, d, A, B, C, D, b = ins
        K, Dm, N = A.shape
        bsz, L = u.shape[0] // K, u.shape[1]
        gen = lambda t: t.reshape(bsz, K, L, -1).transpose(0, 2, 1, 3)
        fold = lambda t: t.reshape(bsz, L, K, -1).transpose(0, 2, 1, 3) \
            .reshape(bsz * K, L, -1)
        args = (gen(u).reshape(bsz, L, K * Dm), gen(d).reshape(bsz, L, -1),
                A.reshape(K * Dm, N), gen(B), gen(C), D.reshape(-1),
                b.reshape(-1))
        y, g = _jit_vjp(lambda *a: jss2d._scan_seq_parallel(*a, "seq"),
                        args, gen(w).reshape(bsz, L, K * Dm))
        back = [fold(g[0]), fold(g[1]), g[2].reshape(K, Dm, N), fold(g[3]),
                fold(g[4]), g[5].reshape(K, Dm), g[6].reshape(K, Dm)]
        return np.asarray(fold(y)), [np.asarray(t) for t in back]
    x, dt, A, B, C, D, b = ins
    y, g = _jit_vjp(lambda x_, dt_, A_, B_, C_, D_, b_:
                    jss2d._ssd_scan_seq_parallel(x_, dt_, A_, B_, C_, D_, b_,
                                                 8, "seq"),
                    (x, dt, A, B, C, D, b), w)
    return np.asarray(y), [np.asarray(t) for t in g]


def _jit_vjp(fn, args, w):
    """fn(*args) and the gradients of sum(fn(*args) * w), jitted (the
    shard_map runs under jit)."""
    def run(args, w):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(w)
    return jax.jit(run)(tuple(args), w)


def _close(got, want, what, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_scans(tmp_path, world):
    """Over ``world`` gloo ranks: make_mesh's data and seq groups (each
    axis's sum of the ranks' ids) at sp 1, 2 and world, its refusals (tp*sp
    not dividing the ranks; a batch size that leaves ranks outside the
    mesh); ``scan_sequence_parallel`` (two passes with the state flags)
    and ``ssd_scan_sequence_parallel`` (return_final_state and the
    correction) against the JAX shard_map and the unsharded plain scans:
    y and all seven input gradients, the same on every rank; and the odd-L
    refusal before any scan."""
    cases = _scan_inputs(np.random.default_rng(world))
    ranks = spawn("scans", world, tmp_path, cases)
    for r, out in enumerate(ranks):
        for sp, groups in out["mesh"]["groups"].items():
            dp = world // sp
            data_ids = [r % sp + sp * d for d in range(dp)]
            seq_ids = [r - r % sp + s for s in range(sp)]
            assert groups["data"] == (dp, r // sp, float(sum(data_ids)))
            assert groups["seq"] == (sp, r % sp, float(sum(seq_ids)))
        not_div, outside = out["mesh"]["raised"]
        assert "not divisible" in not_div
        assert "outside" in outside
        assert out["odd"]["calls"] == []
        assert all("not evenly divisible" in m for m in out["odd"]["msgs"])
        assert len(out["odd"]["msgs"]) == len(SP_MODELS)
    names = ("y",) + tuple(f"d{i}" for i in range(7))
    for i, case in enumerate(cases):
        plain = scan_case(case["kind"], case["inputs"], case["weight"])
        jy, jg = _jax_scan(case, world)
        for r, out in enumerate(ranks):
            y, grads = out["cases"][i]
            for name, got, p, j in zip(names, (y,) + tuple(grads),
                                       (plain[0],) + tuple(plain[1]),
                                       (jy,) + tuple(jg)):
                what = f"{case['kind']} rank {r} {name}"
                _close(got, p, what + " vs unsharded")
                _close(got, j, what + " vs JAX")


def test_odd_l_raises_in_jax():
    """The JAX package refuses the same shapes: a reduced medmamba and
    medssd with seq_axis at 28x28 on an sp 2 mesh raise ValueError while
    tracing."""
    jmesh.make_mesh(tp=1, sp=2, devices=jax.devices()[:2])
    for name, cfg in SP_MODELS.items():
        model = jax_create(name, num_classes=3, seq_axis="seq",
                           scan_impl="xla", **cfg)
        with pytest.raises(ValueError, match="divisible"):
            jax.eval_shape(lambda: model.init(
                jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3))))
