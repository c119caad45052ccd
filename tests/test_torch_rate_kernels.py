"""Port vs JAX: the reverse-rates and Euler-posterior functions.

The plain PyTorch versions are held to the JAX mirrors (`*_xla`) and to the
Pallas kernels in interpret mode, on the same numpy-seeded inputs. Both sides
are float32 with sums in another order: reverse rates within 1e-5 of each
row's largest |value| (a row sums S non-negative terms), log-posteriors
within atol 1e-5 (the tolerance the JAX package's own kernel tests use).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.models.base import DiffusionModel as JaxModel
from ctdd_tpu.ops import forward_process as jfp
from ctdd_tpu.ops import pallas_kernels as pk
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch.models.base import DiffusionModel
from ctdd_tpu_torch.ops import forward_process as tfp
from ctdd_tpu_torch.ops import rate_kernels as rk
from ctdd_tpu_torch.sampling import samplers as ts
from tests.test_torch_unet import one_torch_thread  # noqa: F401

ROW_RTOL = 1e-5


def _inputs(N=2, D=140, S=8, seed=0):
    """The shapes of tests/test_pallas_kernels.py (D ragged against the
    tile), drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((N, D, S)).astype(np.float32),
        (rng.random((N, D, S)) + 0.1).astype(np.float32),
        (rng.random((N, S, S)) + 0.1).astype(np.float32),
        rng.random((N, D, S)).astype(np.float32),
        rng.integers(0, S, (N, D)).astype(np.int32),
    )


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_rows_close(got, want):
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= ROW_RTOL * scale), \
        float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("S", [8, 3, 2])
def test_reverse_rates_plain_matches_jax(ref, S):
    arrays = _inputs(S=S)
    if ref == "xla":
        want = pk.reverse_rates_xla(*_j(arrays))
    else:
        want = pk.reverse_rates_pallas(*_j(arrays), tile_d=64, interpret=True)
    got = rk.reverse_rates_plain(*_t(arrays)).numpy()
    _assert_rows_close(got, np.asarray(want))
    x = arrays[4]
    assert np.all(np.take_along_axis(got, x[..., None].astype(np.int64), -1) == 0.0)
    assert np.abs(got).max() > 0.1


def test_reverse_rates_shared_table_equals_per_sample_copies():
    logits, qc, qt0, rc, x = _t(_inputs(seed=2))
    shared = qt0[0].contiguous()
    want = rk.reverse_rates_plain(logits, qc, shared.expand(2, -1, -1), rc, x)
    got = rk.reverse_rates(logits, qc, shared, rc, x)  # CPU: the plain version
    _assert_rows_close(got.numpy(), want.numpy())
    assert rk.reverse_rates.launches == 0  # no kernel on CPU tensors


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("h", [0.013, 40.0])
def test_euler_posterior_plain_matches_jax(ref, h):
    """h = 40 drives h * sum(post0) past 1 in every row: diag = 0 and the
    entry at x is log(1e-35)."""
    arrays = _inputs(seed=1)
    rev = np.array(pk.reverse_rates_xla(*_j(arrays)))
    x = arrays[4]
    if ref == "xla":
        want = pk.euler_posterior_xla(jnp.asarray(rev), jnp.asarray(x), h)
    else:
        want = pk.euler_posterior_pallas(jnp.asarray(rev), jnp.asarray(x), h,
                                         tile_d=64, interpret=True)
    got = rk.euler_posterior(torch.from_numpy(rev), torch.from_numpy(x), h).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    at_x = np.take_along_axis(got, x[..., None].astype(np.int64), -1)
    if h > 1:
        np.testing.assert_allclose(at_x, np.log(np.float32(1e-35)), rtol=1e-6)
    else:
        assert at_x.min() > -1.0  # staying put is the likely outcome
    assert rk.euler_posterior.launches == 0


@pytest.mark.parametrize("process", ["gaussian", "univar"])
def test_per_sample_reverse_rates_match_jax(process):
    """`samplers.reverse_rates` with a timestep per sample on real process
    tables: the JAX function leaves the entry at x, the port's kernel path
    zeroes it; every other entry and the whole ratio agree. rtol 2e-4 and
    atol 1e-5 as tests/test_shared_rates.py: qt0_cols + eps is ~1e-9 where
    q_{t|0} vanishes, so single terms reach ~1e9 times their neighbours."""
    S, N, D = 8, 3, 7
    if process == "gaussian":
        jproc = jfp.make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0)
        tproc = tfp.make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0, device="cpu")
    else:
        jproc = jfp.make_uniform_variant(S, rate_const=1.3, t_func="log_sqr")
        tproc = tfp.make_uniform_variant(S, 1.3, "log_sqr", device="cpu")
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((N, D, S)).astype(np.float32)
    x = rng.integers(0, S, (N, D)).astype(np.int32)
    t = np.array([0.05, 0.37, 0.9], np.float32)
    want, want_ratio = js.reverse_rates(
        JaxModel(module=None, process=jproc, cfg=None), None,
        jnp.asarray(logits), jnp.asarray(x), jnp.asarray(t),
        rate_param="p0t", logit_type="direct", eps=1e-9,
    )
    got, got_ratio = ts.reverse_rates(
        DiffusionModel(net=None, process=tproc, cfg=None), None,
        torch.from_numpy(logits), torch.from_numpy(x), torch.from_numpy(t),
        rate_param="p0t", logit_type="direct", eps=1e-9,
    )
    off_x = np.arange(S)[None, None, :] != x[..., None]
    np.testing.assert_allclose(got.numpy()[off_x], np.asarray(want)[off_x],
                               rtol=2e-4, atol=1e-5)
    assert np.all(got.numpy()[~off_x] == 0.0)
    np.testing.assert_allclose(got_ratio.numpy(), np.asarray(want_ratio),
                               rtol=2e-4, atol=1e-5)
    # the ratio branch (held against JAX in test_torch_logprob.py) computes
    # on the same inputs: rates 0 at x, the ratio 1 there
    rates, ratio = ts.reverse_rates(
        DiffusionModel(net=None, process=tproc, cfg=None), None,
        torch.from_numpy(logits), torch.from_numpy(x), torch.from_numpy(t),
        rate_param="ratio", logit_type="direct", eps=1e-9,
    )
    assert np.all(rates.numpy()[~off_x] == 0.0) and np.all(rates.numpy() >= 0.0)
    np.testing.assert_allclose(ratio.numpy()[~off_x], 1.0, rtol=1e-6)


def test_reverse_rates_shared_matches_jax_and_keeps_the_entry_at_x():
    """The module-level plain function mirrors JAX's `reverse_rates_shared`
    (unmasked); the samplers' kernel path equals it off x. Same tolerance as
    the per-sample test."""
    S, N, D = 8, 3, 7
    jproc = jfp.make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0)
    tproc = tfp.make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0, device="cpu")
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((N, D, S)).astype(np.float32)
    x = rng.integers(0, S, (N, D)).astype(np.int32)
    kw = dict(rate_param="p0t", logit_type="direct", eps=1e-9)
    want = np.asarray(js.reverse_rates_shared(
        jproc, jnp.asarray(logits), jnp.asarray(x), jnp.float32(0.37), **kw))
    got = ts.reverse_rates_shared(
        tproc, torch.from_numpy(logits), torch.from_numpy(x), 0.37, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    at_x = np.take_along_axis(got, x[..., None].astype(np.int64), -1)
    assert np.abs(at_x).min() > 0  # unmasked, as in JAX
    qt0, rate = ts._shared_mats(tproc, 0.37)
    xl = torch.from_numpy(x).long()
    masked = rk.reverse_rates(torch.from_numpy(logits), qt0.t()[xl] + 1e-9, qt0,
                              rate.t()[xl], torch.from_numpy(x)).numpy()
    off_x = np.arange(S)[None, None, :] != x[..., None]
    np.testing.assert_array_equal(masked[off_x], got[off_x])
    assert np.all(masked[~off_x] == 0.0)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        rk.reverse_rates(meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        rk.euler_posterior(meta, meta, 0.1)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Run where a CUDA device and nvcc are (python -m pytest -m cuda);
    chip_smoke.py holds the same comparison at the serving shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    arrays = [a.cuda() for a in _t(_inputs(N=3, D=77, S=8, seed=3))]
    want = rk.reverse_rates_plain(*arrays)
    got = rk.reverse_rates(*arrays)
    scale = want.abs().amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= 5e-5 * scale).all())
    x = arrays[4]
    assert bool((got.gather(-1, x.long()[..., None]) == 0).all())
    logp = rk.euler_posterior(got, x, 0.013)
    torch.testing.assert_close(logp, rk.euler_posterior_plain(want, x, 0.013),
                               rtol=0, atol=5e-5)
