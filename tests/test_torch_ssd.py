"""The port's SSD scan module against the JAX package's: the chunk choices
(``_pick_chunk``, ``ssd_dirs_chunk``), the einsum path ``ssd_chunked`` and
the golden recurrence ``ssd_seq_ref``, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd as jssd
import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
import medical_image_classification_tpu_torch.kernels.ssd as tssd

torch.set_num_threads(2)

# (L, H4, d_ssm) of medssd's four stages at 224x224 (N = 4 x 128, P = 64)
MEDSSD_STAGES = ((3136, 8, 128), (784, 16, 256), (196, 32, 512),
                 (49, 64, 1024))


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX dirs gate as its own tests run it on the CPU."""
    monkeypatch.setattr(jsfd, "_INTERPRET", True)


def test_dirs_chunk_matches_jax_at_medssd_stages(jax_interpret):
    got = [tssd.ssd_dirs_chunk(L, 256, 512, 64, H4, d_ssm)
           for L, H4, d_ssm in MEDSSD_STAGES]
    want = [jssd.ssd_dirs_chunk(L, 256, 512, 64, H4, 2, d_ssm=d_ssm)
            for L, H4, d_ssm in MEDSSD_STAGES]
    assert got == want == [224, 196, None, None]
    # the same choices in fp32: the port has no fp32 term in its gate, and
    # the JAX gate drops its own in interpret mode
    assert [tssd.ssd_dirs_chunk(L, 256, 512, 64, H4, d)
            for L, H4, d in MEDSSD_STAGES] == \
        [jssd.ssd_dirs_chunk(L, 256, 512, 64, H4, 4, d_ssm=d)
         for L, H4, d in MEDSSD_STAGES]


@pytest.mark.parametrize("L,chunk,N", [
    (3136, 256, 512), (49, 256, 512), (784, 256, 512), (3137, 256, 512),
    (196, 256, 512), (3136, 256, 64), (784, 256, 64), (196, 256, 64),
    (49, 256, 64), (64, 16, 128), (100, 32, 4)])
def test_pick_chunk_matches_jax(L, chunk, N):
    assert tssd._pick_chunk(L, chunk, N) == jssd._pick_chunk(L, chunk, N)


def test_dirs_chunk_small_window_matches_jax(jax_interpret, monkeypatch):
    """With the window widened to l >= 8 on both sides (as the JAX tests
    do): the reduced shapes the CPU tests run, and the shape terms."""
    monkeypatch.setattr(jsfd, "_MIN_L", 8)
    monkeypatch.setattr(tssd, "_MIN_L", 8)
    for L, chunk, N, P, H4, d_ssm in (
            (64, 16, 128, 8, 16, 32), (64, 16, 128, 8, 16, 40),
            (16, 16, 128, 8, 32, 64), (4, 16, 128, 8, 64, 128),
            (64, 16, 128, 8, 32, 64), (3136, 256, 512, 64, 8, 128)):
        assert tssd.ssd_dirs_chunk(L, chunk, N, P, H4, d_ssm) == \
            jssd.ssd_dirs_chunk(L, chunk, N, P, H4, 4, d_ssm=d_ssm), \
            (L, chunk, N, P, H4, d_ssm)


def _make(seed, b, L, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(b, L, h, p), dt=0.5 * f(b, L, h),
                A=-np.exp(0.5 * f(h)), B=f(b, L, g, n), C=f(b, L, g, n),
                D=f(h), dt_bias=np.full((h,), 0.1, np.float32))


def _jax_args(a, dtype):
    cast = {"x", "dt", "B", "C"}
    return {k: jnp.asarray(v, dtype if k in cast else jnp.float32)
            for k, v in a.items()}


def _torch_args(a, dtype):
    cast = {"x", "dt", "B", "C"}
    return {k: torch.from_numpy(v).to(dtype if k in cast else torch.float32)
            for k, v in a.items()}


# fp32: both sides sum the same products in other orders; bf16: operands
# and the einsum outputs are rounded to bf16 on both sides, at the same
# places, and land one bf16 step apart where the fp32 sums straddle a
# rounding midpoint
DTYPES = [("fp32", jnp.float32, torch.float32, 1e-4, 1e-4),
          ("bf16", jnp.bfloat16, torch.bfloat16, 3e-2, 5e-2)]


# (L, chunk, N): one chunk (a small state: pad-free up to L 256), seven
# chunks with 12 rows of padding, four pad-free chunks (N >= 256: chunks of
# 7/8 chunk_size to chunk_size)
@pytest.mark.parametrize("name,jdt,tdt,rtol,atol", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("L,chunk,n", [(64, 16, 4), (100, 16, 256),
                                       (64, 16, 256)])
@pytest.mark.parametrize("g,h", [(1, 2), (2, 4)])
def test_ssd_chunked_matches_jax(name, jdt, tdt, rtol, atol, L, chunk, n, g,
                                 h):
    a = _make(L + h, 2, L, h, 8, g, n)
    aj, at = _jax_args(a, jdt), _torch_args(a, tdt)
    yj = jssd.ssd_chunked(aj["x"], aj["dt"], aj["A"], aj["B"], aj["C"],
                          chunk_size=chunk, D=aj["D"], dt_bias=aj["dt_bias"])
    yt = tssd.ssd_chunked(at["x"], at["dt"], at["A"], at["B"], at["C"], chunk,
                          at["D"], at["dt_bias"])
    assert yt.dtype == tdt and yt.shape == (2, L, h, 8)
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,jdt,tdt,rtol,atol", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("L,g,h", [(40, 1, 2), (33, 2, 4)])
def test_ssd_seq_ref_matches_jax(name, jdt, tdt, rtol, atol, L, g, h):
    a = _make(7 * L, 2, L, h, 8, g, 4)
    z = np.random.default_rng(L).standard_normal((2, L, h, 8)).astype(
        np.float32)
    aj, at = _jax_args(a, jdt), _torch_args(a, tdt)
    yj, sj = jssd.ssd_seq_ref(aj["x"], aj["dt"], aj["A"], aj["B"], aj["C"],
                              D=aj["D"], z=jnp.asarray(z),
                              dt_bias=aj["dt_bias"], return_final_state=True)
    yt, st = tssd.ssd_seq_ref(at["x"], at["dt"], at["A"], at["B"], at["C"],
                              D=at["D"], z=torch.from_numpy(z),
                              dt_bias=at["dt_bias"], return_final_state=True)
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(st.float().numpy(), np.asarray(sj, np.float32),
                               rtol=rtol, atol=atol)


def test_ssd_chunked_matches_recurrence_and_chains():
    """The port's chunked scan against its own golden recurrence (fp32,
    2e-4: chunking only changes the order of summation), with the state
    chained over six pad-free chunks and over seven padded ones."""
    for L in (96, 100):
        assert tssd._pick_chunk(L, 16, 256) == 16
        a = _make(L, 2, L, 4, 8, 2, 256)
        t = _torch_args(a, torch.float32)
        args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
        y_ref = tssd.ssd_seq_ref(*args, D=t["D"], dt_bias=t["dt_bias"])
        y = tssd.ssd_chunked(*args, 16, t["D"], t["dt_bias"])
        torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)


def test_dirs_chunk_card_terms():
    """On the card the gate also needs P and N to be multiples of 32 (the
    CUDA kernels' tiles) and N <= 512; medssd's choices stay the same
    there."""
    assert [tssd.ssd_dirs_chunk(L, 256, 512, 64, H4, d, card=True)
            for L, H4, d in MEDSSD_STAGES] == [224, 196, None, None]
    for N, P, H4, d_ssm in ((512, 16, 32, 128), (512, 8, 64, 128),
                            (16, 64, 8, 128), (1024, 64, 16, 256)):
        assert tssd.ssd_dirs_chunk(3136, 256, N, P, H4, d_ssm) == 224
        assert tssd.ssd_dirs_chunk(3136, 256, N, P, H4, d_ssm,
                                   card=True) is None
