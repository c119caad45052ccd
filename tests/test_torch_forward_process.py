"""Port vs JAX: forward-process rate / transition / transit_between.

Both sides start from the same float64 numpy eigendecomposition cast to
float32, so they differ only in the order of the float32 sums of the
propagator product and in pow/exp ulps: atol 1e-6, rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.ops import forward_process as jfp
from ctdd_tpu_torch.ops import forward_process as tfp
from tests.test_torch_unet import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-6, 1e-4
TS = np.array([0.01, 0.1, 0.37, 0.72, 1.0], np.float32)



def _make(m, fn, *args, **kwargs):
    """The port builds on the GPU unless told otherwise; JAX takes no device."""
    if m is tfp:
        kwargs["device"] = "cpu"
    return getattr(m, fn)(*args, **kwargs)


_PROCESSES = {
    "gaussian_target": lambda m, S: _make(m, "make_gaussian_target", S, 6.0, 512.0, 3.0, 100.0),
    "uniform": lambda m, S: _make(m, "make_uniform", S, 1.5),
    "uniform_variant_sqrt_cos": lambda m, S: _make(m, "make_uniform_variant", S, 2.0, "sqrt_cos"),
    "uniform_variant_log": lambda m, S: _make(
        m, "make_uniform_variant", S, 1.0, "log", time_base=3.0, time_exp=100.0),
    "birth_death": lambda m, S: _make(m, "make_birth_death", S, 1.0, 100.0),
}

_CASES = [(name, 8) for name in _PROCESSES] + [("gaussian_target", 256)]


def _both(name, S):
    return _PROCESSES[name](jfp, S), _PROCESSES[name](tfp, S)


@pytest.mark.parametrize("name,S", _CASES)
def test_rate_matches_jax(name, S):
    jp, tp = _both(name, S)
    want = np.asarray(jp.rate(jnp.asarray(TS)))
    got = tp.rate(torch.from_numpy(TS)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,S", _CASES)
def test_transition_matches_jax(name, S):
    jp, tp = _both(name, S)
    want = np.asarray(jp.transition(jnp.asarray(TS)))
    got = tp.transition(torch.from_numpy(TS)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,S", _CASES)
def test_transit_between_matches_jax(name, S):
    jp, tp = _both(name, S)
    t1 = TS[:-1]
    t2 = TS[1:]
    want = np.asarray(jp.transit_between(jnp.asarray(t1), jnp.asarray(t2)))
    got = tp.transit_between(torch.from_numpy(t1), torch.from_numpy(t2)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rate_mat_gathers_rows():
    jp, tp = _both("gaussian_target", 8)
    y = np.random.default_rng(0).integers(0, 8, (5, 7)).astype(np.int32)
    want = np.asarray(jp.rate_mat(jnp.asarray(y), jnp.asarray(TS)))
    got = tp.rate_mat(torch.from_numpy(y), torch.from_numpy(TS)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
