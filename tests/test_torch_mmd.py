"""Port vs JAX: the MMD metrics, and `eval_mmd`.

The port sums its kernel matrices in float64, JAX in float32. So both are
held to a float64 numpy reference of the same formula: the port within
1e-6 relative (measured 1e-8 to 2e-7), JAX within its own float32 error
(measured 1.8e-6 to 2e-4 relative at these sizes, larger where the MMD is
small); port vs JAX within that error plus 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.metrics import mmd as J
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.metrics import mmd as T
from tests.test_torch_unet import one_torch_thread  # noqa: F401


def _bits(n, d, p, seed):
    return (np.random.RandomState(seed).rand(n, d) < p).astype(np.int32)


def _reference(x, y, dist, sim, unbiased=True):
    """float64 numpy MMD with the broadcast distance `dist(a, b)`."""
    x, y = x.astype(np.float64), y.astype(np.float64)

    def k(a, b):
        return sim(dist(a[:, None, :], b[None, :, :]).sum(-1))

    if not unbiased:
        return k(x, x).mean() + k(y, y).mean() - 2 * k(x, y).mean()
    n, m = len(x), len(y)
    kxx, kyy = k(x, x), k(y, y)
    return ((kxx.sum() - np.trace(kxx)) / (n * (n - 1))
            + (kyy.sum() - np.trace(kyy)) / (m * (m - 1)) - 2 * k(x, y).mean())


def _l1(a, b):
    return np.abs(a - b)


def _neq(a, b):
    return (a != b).astype(np.float64)


def _exp(d):
    return np.exp(-0.1 * d)


def _assert_port_and_jax(port, jax_value, ref):
    port, jax_value = float(port), float(jax_value)
    assert abs(port - ref) <= 1e-6 * abs(ref), (port, ref)
    jax_err = abs(jax_value - ref)
    assert jax_err <= 5e-4 * abs(ref), (jax_value, ref)  # JAX's own float32 error
    assert abs(port - jax_value) <= jax_err + 1e-6 * abs(ref)


CASES = [((0.2, 0.8), 512, 32), ((0.3, 0.35), 512, 32), ((0.5, 0.5), 300, 16)]


@pytest.mark.parametrize("probs,n,d", CASES)
@pytest.mark.parametrize("name", ["binary_exp_hamming_mmd", "binary_hamming_mmd",
                                  "categorical_exp_hamming_mmd"])
def test_binary_inputs_match_jax(name, probs, n, d):
    x, y = _bits(n, d, probs[0], 0), _bits(n, d, probs[1], 1)
    sim = (lambda dd: d - dd) if name == "binary_hamming_mmd" else _exp
    dist = _neq if name.startswith("categorical") else _l1
    _assert_port_and_jax(getattr(T, name)(x, y), getattr(J, name)(jnp.asarray(x), jnp.asarray(y)),
                         _reference(x, y, dist, sim))


@pytest.mark.parametrize("name", ["binary_exp_hamming_mmd", "categorical_exp_hamming_mmd"])
def test_categorical_inputs_match_jax(name):
    """S=5 tokens: the L1 kernel of the binary MMD and the count of entries
    that differ of the categorical one; the first takes the blockwise
    broadcast (the data is not 0/1)."""
    rng = np.random.RandomState(4)
    x, y = rng.randint(0, 5, (300, 16)), np.minimum(rng.randint(0, 6, (260, 16)), 4)
    dist = _neq if name.startswith("categorical") else _l1
    _assert_port_and_jax(getattr(T, name)(x, y), getattr(J, name)(jnp.asarray(x), jnp.asarray(y)),
                         _reference(x, y, dist, _exp))


def test_float_space_variants_match_jax():
    jcfg, cfg = jax_get_preset("mlp_synthetic"), get_preset("mlp_synthetic")
    x, y = _bits(200, 32, 0.5, 0), _bits(180, 32, 0.4, 1)
    xf, yf = (T.bin2float(a, 32, cfg.data.int_scale, cfg.data.binmode) for a in (x, y))
    _assert_port_and_jax(T.exp_hamming_mmd(x, y, cfg), J.exp_hamming_mmd(x, y, jcfg),
                         _reference(xf, yf, _l1, _exp))
    _assert_port_and_jax(T.mmd_rbf(x, y, cfg), J.mmd_rbf(x, y, jcfg),
                         _reference(xf, yf, lambda a, b: (a - b) ** 2,
                                    lambda d2: np.exp(-0.2 * d2), unbiased=False))


def test_eval_mmd_matches_jax():
    """The same ground-truth rows (RandomState(seed) indices on both sides)
    against the same rows from each round's `sample_fn`."""
    data = _bits(1000, 16, 0.3, 0)

    class DS:
        def __init__(self):
            self.data = data

        def __len__(self):
            return len(self.data)

    rounds = [data[np.random.RandomState(100 + r).randint(0, 1000, 128)] for r in range(3)]

    def feeder():
        it = iter(rounds)
        return lambda key_or_generator, n: next(it)[:n]

    cfg = get_preset("mlp_synthetic")
    port = T.eval_mmd(cfg, feeder(), DS(), n_rounds=3, n_samples=128, device="cpu")
    want = J.eval_mmd(jax_get_preset("mlp_synthetic"), feeder(), DS(), n_rounds=3,
                      n_samples=128)
    rng = np.random.RandomState(0)
    ref = np.mean([_reference(data[rng.randint(0, 1000, size=128)], rows, _l1, _exp)
                   for rows in rounds])
    assert abs(port - ref) <= 1e-6 * abs(ref) + 1e-9
    assert abs(port - want) <= abs(want - ref) + 1e-6 * abs(ref) + 1e-9


def test_eval_mmd_generators_are_seeded_per_round():
    seen = []

    def sample_fn(generator, n):
        """numpy on the first call of a round pair, a tensor on the second:
        eval_mmd takes both."""
        assert generator.device.type == "cpu"
        seen.append(torch.randint(0, 2, (n, 4), generator=generator))
        return seen[-1] if len(seen) % 2 else seen[-1].numpy()

    class DS:
        data = _bits(50, 4, 0.5, 0)

        def __len__(self):
            return 50

    T.eval_mmd(get_preset("mlp_synthetic"), sample_fn, DS(), n_rounds=2, n_samples=64,
               seed=3, device="cpu")
    T.eval_mmd(get_preset("mlp_synthetic"), sample_fn, DS(), n_rounds=2, n_samples=64,
               seed=3, device="cpu")
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])
    assert not torch.equal(seen[0], seen[1])


def test_product_form_equals_broadcast_at_the_reference_protocol():
    """N=4096, D=32 (the reference protocol): the product form of the 0/1
    distance equals the blockwise broadcast |x - y| entry for entry."""
    x = torch.from_numpy(_bits(4096, 32, 0.3, 0)).float()
    y = torch.from_numpy(_bits(4096, 32, 0.6, 1)).float()
    prod = T._l1(x, y)
    broadcast = T._blockwise(x, y, lambda a, b: (a - b).abs())
    assert prod.shape == (4096, 4096)
    assert torch.equal(prod, broadcast)
