"""Port vs optax: the learning-rate schedules, and clip + Adam / AdamW on
identical gradients.

Schedules: the port computes in float64 and rounds to float32 where it
scales an update, optax computes in float32: rtol 1e-6. Five optimizer
steps from the same params and gradients, the global norm above the clip
threshold on some steps and below on others: params, mu and nu to rtol 1e-6
plus 1e-6 of the array's largest |value| (float32 on both sides; the global
norm sums in another order, and a moment that sums gradients of both signs
keeps their rounding), count equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ctdd_tpu.training.optimizers import _schedule as jax_schedule
from ctdd_tpu.training.optimizers import get_optimizer as jax_optimizer
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.convert import _find_adam_state
from ctdd_tpu_torch.training.optimizers import _schedule, get_optimizer
from tests.test_torch_unet import one_torch_thread  # noqa: F401


def _cfgs(**opt):
    """(JAX cfg, port cfg) of the flagship with training/optimizer fields set."""
    cfg = _flagship_cfg(tiny=True)
    for k, v in opt.items():
        section, key = k.split("__")
        cfg[section][key] = v
    return cfg, Config(cfg.to_dict())


SCHEDULES = {
    "constant": dict(),
    "warmup": dict(training__warmup=5),
    "cosine": dict(optimizer__schedule="cosine", training__n_iters=20),
    "linear": dict(optimizer__schedule="linear", training__n_iters=20),
    "warmup_cosine": dict(optimizer__schedule="cosine", training__n_iters=20,
                          training__warmup=4),
    "warmup_linear": dict(optimizer__schedule="linear", training__n_iters=20,
                          training__warmup=4, optimizer__end_lr_factor=0.3),
    # ADVICE.md's quirk, kept: n_iters <= warmup decays within one step
    "n_iters_le_warmup": dict(optimizer__schedule="cosine", training__n_iters=3,
                              training__warmup=5),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_optax(case):
    cfg, tcfg = _cfgs(**SCHEDULES[case])
    js, ts = jax_schedule(cfg), _schedule(tcfg)
    for count in range(0, 30):
        want = float(js(jnp.int32(count))) if callable(js) else float(js)
        np.testing.assert_allclose(ts(count), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"{case} at count {count}")


def test_unknown_schedule_raises():
    _, tcfg = _cfgs(optimizer__schedule="step")
    with pytest.raises(ValueError, match="unknown optimizer.schedule"):
        _schedule(tcfg)


@pytest.mark.parametrize("name,schedule", [("Adam", "constant"), ("AdamW", "constant"),
                                           ("Adam", "warmup_cosine")])
def test_clip_adam_matches_optax(name, schedule):
    cfg, tcfg = _cfgs(optimizer__name=name, **SCHEDULES[schedule])
    assert cfg.training.clip_grad and cfg.training.grad_norm == 2.0
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jtx = jax_optimizer(cfg)
    jstate = jtx.init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = get_optimizer(tcfg)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tx.init(tparams)
    norms = []
    for step in range(5):
        # global norm ~0.6 or ~6, against the threshold of 2
        scale = 0.1 if step % 2 else 1.0
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        norms.append(np.sqrt(sum((g ** 2).sum() for g in grads.values())))
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                     jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = tx.update(tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
                           tstate)
    assert min(norms) < 2.0 < max(norms)
    adam = _find_adam_state(jstate)
    assert tstate.count == int(adam.count) == 5
    for mine, theirs in ((tparams, jparams), (tstate.mu, adam.mu), (tstate.nu, adam.nu)):
        for k in shapes:
            want = np.asarray(theirs[k])
            np.testing.assert_allclose(mine[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)
