"""Port vs JAX: train steps from a converted JAX train state, the
non-finite skip, and the EMA ramp.

One JAX step first (so optax's count, mu and nu are not trivial), then the
state is converted with `train_state_from_flax`, and one and three further
steps run on both sides from the same injected x0, times and (x_t, x̃),
dropout off: JAX through `value_and_grad(_ctelbo_terms)` + `apply_update`,
the port through its own. Tolerances (float32 on both sides): the loss to
rtol 1e-5; each gradient leaf to 1e-4 of its largest |g|; params and EMA to
1e-2 of the learning rate (an Adam step moves a weight by up to ~lr, and the
gradients differ by ~5e-6 of a leaf's largest); mu and nu to 1e-4 of each
leaf's largest value; count, step and the EMA count equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.losses import losses as JL
from ctdd_tpu.training.optimizers import get_optimizer as jax_optimizer
from ctdd_tpu.training.state import TrainState as JaxTrainState
from ctdd_tpu.training.state import create_train_state as jax_train_state
from ctdd_tpu.training.train_step import apply_update as jax_apply_update
from ctdd_tpu_torch.convert import _find_adam_state, train_state_from_flax, unet_params_from_flax
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.training.optimizers import get_optimizer
from ctdd_tpu_torch.training.state import create_train_state
from ctdd_tpu_torch.losses.losses import get_loss
from ctdd_tpu_torch.training.train_step import (
    NAN_SENTINEL, apply_update, get_train_step, make_device_data_step, value_and_grad,
)
from tests.test_torch_losses import assert_grads_close, injected, tiny_pair
from tests.test_torch_unet import flagship_cfgs, one_torch_thread  # noqa: F401


def _flax(tree, tcfg):
    return unet_params_from_flax(jax.tree_util.tree_map(np.asarray, tree), tcfg)


def _close_by_leaf(mine, want, rel, what):
    for k, v in mine.items():
        err = (v.detach() - want[k]).abs().max().item()
        assert err <= rel * max(want[k].abs().max().item(), 1e-30), (what, k, err)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_steps_from_converted_state_match_jax(n_steps):
    cfg, tcfg, jmodel, params, tmodel = tiny_pair()
    eps, decay = cfg.loss.eps_ratio, float(cfg.model.ema_decay)
    lr = float(cfg.optimizer.lr)
    jtx, tx = jax_optimizer(cfg), get_optimizer(tcfg)
    jstate = jax_train_state(params, jtx)

    @jax.jit
    def jax_update(state, x0, ts, xt, xtl):
        l, g = jax.value_and_grad(lambda p: JL._ctelbo_terms(
            jmodel, p, jax.random.PRNGKey(0), x0, ts, eps, True, False, None,
            samples=(xt, xtl))[0])(state.params)
        state, lj = jax_apply_update(state, l, g, jtx, decay)
        return state, lj, g

    def jax_step(state, k):
        state, lj, g = jax_update(state, *(jnp.asarray(a) for a in injected(tmodel, seed=k)))
        return state, float(lj), g

    jstate, _, _ = jax_step(jstate, 100)
    tstate = train_state_from_flax(jstate, tcfg)
    assert (tstate.step, tstate.opt_state.count, tstate.ema_num_updates) == (1, 1, 1)
    for k in range(n_steps):
        jstate, jl, jg = jax_step(jstate, k)
        x0, ts, xt, xtl = (torch.from_numpy(a) for a in injected(tmodel, seed=k))
        value, grads = value_and_grad(lambda p: TL._ctelbo_terms(
            tmodel, p, None, x0, ts, eps, True, False, samples=(xt, xtl))[0],
            tstate.params)
        tstate, tl = apply_update(tstate, value, grads, tx, decay)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert_grads_close(jg, grads, tcfg)
    adam = _find_adam_state(jstate.opt_state)
    assert tstate.step == int(jstate.step) == 1 + n_steps
    assert tstate.opt_state.count == int(adam.count) == 1 + n_steps
    assert tstate.ema_num_updates == int(jstate.ema_num_updates) == 1 + n_steps
    for mine, theirs in ((tstate.params, jstate.params), (tstate.ema_params, jstate.ema_params)):
        want = _flax(theirs, tcfg)
        for name, v in mine.items():
            np.testing.assert_allclose(v.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-2 * lr, err_msg=name)
    _close_by_leaf(tstate.opt_state.mu, _flax(adam.mu, tcfg), 1e-4, "mu")
    _close_by_leaf(tstate.opt_state.nu, _flax(adam.nu, tcfg), 1e-4, "nu")


class _NaNLoss:
    """A loss whose value is NaN on the steps in `bad` and finite otherwise."""

    def __init__(self, bad):
        self.bad = bad

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        value = sum((v ** 2).sum() for v in params.values()) * 1e-3
        return value * float("nan") if n_iter in self.bad else value


def test_non_finite_loss_skips_the_update():
    """A NaN loss returns the 1e9 sentinel; params, optimizer state and EMA
    stay bit for bit; `step` advances; the next finite step updates."""
    _, tcfg, _, _, tmodel = tiny_pair()
    tx = get_optimizer(tcfg)
    state = create_train_state(dict(tmodel.net.named_parameters()), tx)
    step = make_device_data_step(tmodel, _NaNLoss(bad={1}), tx, batch_size=2,
                                 ema_decay=0.9999)
    data = torch.zeros((8, 64), dtype=torch.int32)
    state, l0 = step(state, data, 0)
    assert l0 < NAN_SENTINEL and state.step == 1 and state.opt_state.count == 1
    before = {name: {k: v.detach().clone() for k, v in d.items()}
              for name, d in (("params", state.params), ("ema", state.ema_params),
                              ("mu", state.opt_state.mu), ("nu", state.opt_state.nu))}
    state, l1 = step(state, data, 0)
    assert l1 == NAN_SENTINEL
    assert (state.step, state.opt_state.count, state.ema_num_updates) == (2, 1, 1)
    for name, d in (("params", state.params), ("ema", state.ema_params),
                    ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert all(torch.equal(d[k], before[name][k]) for k in d), name
    state, l2 = step(state, data, 0)
    assert l2 < NAN_SENTINEL
    assert (state.step, state.opt_state.count, state.ema_num_updates) == (3, 2, 2)
    assert not all(torch.equal(state.params[k], before["params"][k]) for k in state.params)


@pytest.mark.parametrize("n", [0, 3, 120, 100000])
def test_ema_ramp_matches_jax(n):
    """min(decay, (1+n)/(10+n)) in float32 on both sides: bit for bit."""
    rng = np.random.default_rng(n)
    s = {"w": rng.standard_normal((5, 4)).astype(np.float32)}
    p = {"w": rng.standard_normal((5, 4)).astype(np.float32)}
    jstate = JaxTrainState(params=None, ema_params=s, opt_state=None, step=0,
                           ema_num_updates=jnp.int32(n))
    want, jn = jstate.ema_update(p, 0.9999)
    tx = get_optimizer(flagship_cfgs("tiny")[1])
    tstate = create_train_state({"w": torch.zeros(5, 4)}, tx)
    tstate.ema_params = {"w": torch.from_numpy(s["w"].copy())}
    tstate.ema_num_updates = n
    tn = tstate.ema_update({"w": torch.from_numpy(p["w"])}, 0.9999)
    assert tn == int(jn) == n + 1
    np.testing.assert_array_equal(tstate.ema_params["w"].numpy(), np.asarray(want["w"]))


def test_standard_builds_the_host_batch_step():
    """cfg.training.train_step_name resolves to a step over host batches;
    the same (seed, step) gives the same loss."""
    _, tcfg, _, _, tmodel = tiny_pair()
    tx = get_optimizer(tcfg)
    step = get_train_step(tcfg).build(tmodel, get_loss(tcfg), tx)
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 8, (2, 64)).astype(np.int32))
    losses = []
    for _ in range(2):
        state = create_train_state({k: v.detach().clone() for k, v in
                                    tmodel.net.named_parameters()}, tx)
        state, value = step(state, batch, 7)
        losses.append(value)
        assert (state.step, state.opt_state.count, state.ema_num_updates) == (1, 1, 1)
    assert losses[0] == losses[1] < NAN_SENTINEL
