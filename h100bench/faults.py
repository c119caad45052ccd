"""Faults planted in the program underneath the harness.

Each is Python run at the start of a run's process, before the harness
starts: the harness's own tests run it in every process of a run (a
`sitecustomize` module, so that the ranks a multi-card cell starts carry
it too), and `control.py --variant <name>` runs a fault of `PLANTED` on
the card at a cell's own size. A sound harness finds each of them not
correct; none is run by the benchmark's own runs.
"""

# generation: the tau-leap update returns the state it was given
UNCHANGED_SAMPLER = """
import ctdd_tpu_torch.sampling.samplers as s
s.fused_tau_leap_update = lambda logits, x_gather, x_base, *a, **k: x_base.clone()
"""
# generation: one token of the denoised samples altered where it is made
TOKEN_ALTERED = """
import ctdd_tpu_torch.sampling.samplers as s
_denoise = s._denoise_argmax
def altered(*a, **k):
    x = _denoise(*a, **k)
    x[0, 0] = (x[0, 0] + 1) % 256
    return x
s._denoise_argmax = altered
"""
# generation: every jump of the tau-leap update goes the other way
REFLECTED = """
import ctdd_tpu_torch.sampling.samplers as s
_update = s.fused_tau_leap_update
def reflected(logits, x_gather, x_base, *a, **k):
    y = _update(logits, x_gather, x_base, *a, **k)
    return (2 * x_base - y).clamp(0, logits.shape[-1] - 1).to(y.dtype)
s.fused_tau_leap_update = reflected
"""
# generation: a dimension that jumps lands on a state drawn uniformly
UNIFORM_DESTINATIONS = """
import torch
import ctdd_tpu_torch.sampling.samplers as s
_update = s.fused_tau_leap_update
def uniform(logits, x_gather, x_base, *a, **k):
    y = _update(logits, x_gather, x_base, *a, **k)
    S = logits.shape[-1]
    shift = torch.randint(1, S, y.shape, device=y.device, dtype=y.dtype)
    return torch.where(y != x_base, (x_base + shift) % S, y)
s.fused_tau_leap_update = uniform
"""
# training: the step returns its state unchanged but for the step count
UNCHANGED_STATE = """
import dataclasses
import ctdd_tpu_torch.training.train_step as ts
ts.apply_update = lambda state, loss, grads, tx, decay: (
    dataclasses.replace(state, step=state.step + 1), float(loss))
"""
# training: the loss's mean taken over the first half of the batch
HALF_BATCH = """
import ctdd_tpu_torch.training.train_step as ts
_make = ts.make_loss_fn
def half(model, loss, augment_fn=None):
    fn = _make(model, loss, augment_fn)
    return lambda params, batch, *a: fn(params, batch[: batch.shape[0] // 2], *a)
ts.make_loss_fn = half
"""
# training over several cards: the all-reduce left out
NO_EXCHANGE = """
import ctdd_tpu_torch.parallel.dp as dp
dp.pmean = lambda mesh, loss, grads: (loss, grads)
"""
# a rank above 0 has a module named jax loaded
JAX_ON_A_RANK = """
import sys, types
if "--rank" in sys.argv and sys.argv[sys.argv.index("--rank") + 1] != "0":
    sys.modules["jax"] = types.ModuleType("jax")
"""

# the faults `control.py` reads on the card, by name
PLANTED = {"reflected": REFLECTED, "uniform_destinations": UNIFORM_DESTINATIONS}
