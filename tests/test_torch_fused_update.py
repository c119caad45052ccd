"""Port's plain fused tau-leap update vs the JAX kernel and its mirror.

"expected" mode: against the Pallas kernel in interpret mode, exactly.
"poisson" mode: against fused_tau_leap_update_xla with the same injected
uniforms. Both sides round the tables and `a` to bf16 and sum the ratio
product in f32 in different orders, so a borderline CDF comparison may in
principle flip; at most 0.1% of states may differ there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.ops import fused_update as jfu
from ctdd_tpu_torch.ops import fused_update as tfu
from tests.test_torch_unet import one_torch_thread  # noqa: F401

MAX_FLIP_FRAC = 1e-3


def _inputs(N=2, D=96, S=128, seed=0):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((N, D, S))).astype(np.float32)
    qt0 = rng.random((S, S)) * 0.1 + 1e-3
    qt0 = (qt0 / qt0.sum(-1, keepdims=True)).astype(np.float32)
    rate = (rng.random((S, S)) * 3.0).astype(np.float32)
    x = rng.integers(0, S, (N, D)).astype(np.int32)
    u = rng.random((N, D, S)).astype(np.float32)
    return logits, qt0, rate, x, u


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "N,D,S,h,shift",
    [
        (2, 96, 128, 0.37, 0),   # tile-aligned rows
        (2, 96, 128, 0.2, 1),    # distinct x_gather / x_base (midpoint)
        (1, 50, 128, 0.1, 0),    # N*D not a multiple of the tile
        (3, 40, 8, 0.3, 0),      # the tiny flagship S
    ],
)
def test_expected_mode_matches_pallas_interpret(N, D, S, h, shift):
    logits, qt0, rate, x, _ = _inputs(N, D, S, seed=S + shift)
    xg = np.clip(x + shift, 0, S - 1).astype(np.int32)
    want = jfu.fused_tau_leap_update(
        jnp.asarray(logits), jnp.asarray(xg), jnp.asarray(x), jnp.asarray(qt0),
        jnp.asarray(rate), h, 1e-9, 0, mode="expected", tile_r=64,
        interpret=True,
    )
    tl, tq, tr, txg, tx = _torch(logits, qt0, rate, xg, x)
    got = tfu.fused_tau_leap_update_plain(tl, txg, tx, tq, tr, h, 1e-9,
                                          mode="expected")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("is_ordinal", [True, False])
@pytest.mark.parametrize("S,h", [(128, 0.01), (128, 0.002), (8, 0.3)])
def test_poisson_mode_matches_mirror_with_injected_u(is_ordinal, S, h):
    logits, qt0, rate, x, u = _inputs(3, 64, S, seed=7 + S)
    want = np.asarray(jfu.fused_tau_leap_update_xla(
        jnp.asarray(logits), jnp.asarray(x), jnp.asarray(x), jnp.asarray(qt0),
        jnp.asarray(rate), h, 1e-9, u=jnp.asarray(u), mode="poisson",
        is_ordinal=is_ordinal,
    ))
    tl, tq, tr, tx, tu = _torch(logits, qt0, rate, x, u)
    got = tfu.fused_tau_leap_update_plain(
        tl, tx, tx, tq, tr, h, 1e-9, tu, mode="poisson", is_ordinal=is_ordinal
    ).numpy()
    assert np.mean(got != want) <= MAX_FLIP_FRAC
    assert np.mean(got != x) > 0.01  # the step moved states: not vacuous


def test_nonordinal_rejection_keeps_state():
    logits, qt0, rate, x, _ = _inputs(seed=5)
    tl, tq, tr, tx = _torch(logits, qt0, rate, x)
    u = torch.zeros(tl.shape)  # u = 0 -> zero jumps everywhere
    got = tfu.fused_tau_leap_update_plain(tl, tx, tx, tq, tr, 0.5, 1e-9, u,
                                          mode="poisson", is_ordinal=False)
    np.testing.assert_array_equal(got.numpy(), x)


def test_wrapper_on_cpu_uses_plain_version_and_counts_no_launch():
    logits, qt0, rate, x, u = _inputs(2, 16, 8, seed=3)
    tl, tq, tr, tx, tu = _torch(logits, qt0, rate, x, u)
    before = tfu.fused_tau_leap_update.launches
    got = tfu.fused_tau_leap_update(tl, tx, tx, tq, tr, 0.2, 1e-9, 0, u=tu)
    want = tfu.fused_tau_leap_update_plain(tl, tx, tx, tq, tr, 0.2, 1e-9, tu)
    assert torch.equal(got, want)
    # seeded draws: same seed, same states
    a = tfu.fused_tau_leap_update(tl, tx, tx, tq, tr, 0.2, 1e-9, 11)
    b = tfu.fused_tau_leap_update(tl, tx, tx, tq, tr, 0.2, 1e-9, 11)
    assert torch.equal(a, b)
    # the high word (the sampler's step index) changes the draws
    c = tfu.fused_tau_leap_update(tl, tx, tx, tq, tr, 0.2, 1e-9, 11 | (1 << 32))
    assert not torch.equal(a, c)
    assert tfu.fused_tau_leap_update.launches == before


def test_kernel_request_without_cuda_raises():
    """No fallback: a tensor on neither the CPU nor a card is refused, and
    without the CUDA toolkit binding the kernel raises."""
    from ctdd_tpu_torch.ops import _build

    logits, qt0, rate, x, _ = _inputs(1, 8, 8, seed=4)
    tl, tq, tr, tx = _torch(logits, qt0, rate, x)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        tfu.fused_tau_leap_update(tl.to("meta"), tx, tx, tq, tr, 0.1, 1e-9, 0)
    if torch.cuda.is_available() or _build.library_path("fused_tau_leap").exists():
        pytest.skip("the kernel can be built or is built here")
    try:
        _build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfu._bind()
    else:
        pytest.skip("nvcc is installed here")
