"""Port vs JAX: on-device augmentation (ctdd_tpu_torch/data/augment.py
against ctdd_tpu/data/augment.py) on the CPU.

JAX's cases of tests/test_augment.py on the port; then the rotation and the
flip against JAX with JAX's draws injected (the angles are
`jax.random.uniform(key, (B,), minval=-10, maxval=10)`, the flips
`jax.random.bernoulli(key, 0.5, (B,))`): the flip exactly; the rotation
exactly except at a pixel whose rounded source coordinate lies within 1e-4
of a half-integer, where float32 cos/sin an ulp apart may pick the
neighbour; the gating per dataset; and an augmented train step of both
step functions.
"""

import jax
import numpy as np
import pytest
import torch

from ctdd_tpu.data import augment as JA
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.data.augment import make_augment_fn, make_flip_fn, make_rotation_fn
from ctdd_tpu_torch.training import train_step as TS
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

TIE_BAND = 1e-4


def _img_batch(B=8, C=1, H=12, W=12, S=256, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, S, size=(B, C * H * W)).astype(np.int32))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_rotation_zero_degrees_is_identity():
    aug = make_rotation_fn((1, 12, 12), max_deg=1e-9)
    x = _img_batch()
    assert torch.equal(aug(gen(0), x), x)


def test_rotation_preserves_dtype_shape_and_state_validity():
    aug = make_rotation_fn((1, 12, 12), max_deg=10.0)
    x = _img_batch(S=3)
    out = aug(gen(1), x)
    assert out.shape == x.shape and out.dtype == torch.int32
    assert set(out.unique().tolist()) <= set(x.unique().tolist()) | {0}


def test_rotation_fresh_per_item_and_per_step():
    aug = make_rotation_fn((1, 12, 12), max_deg=10.0)
    x = _img_batch()
    assert not torch.equal(aug(gen(1), x), aug(gen(2), x))


def test_flip_is_exact_mirror_or_identity():
    aug = make_flip_fn((3, 8, 8))
    x = _img_batch(B=16, C=3, H=8, W=8)
    out = aug(gen(3), x).reshape(16, 3, 8, 8)
    orig = x.reshape(16, 3, 8, 8)
    flipped = orig.flip(-1)
    assert all(torch.equal(out[i], orig[i]) or torch.equal(out[i], flipped[i])
               for i in range(16))
    assert any(torch.equal(out[i], flipped[i]) and not torch.equal(orig[i], flipped[i])
               for i in range(16))


def _near_half(shape, angles_deg):
    """(B, H*W) mask of the pixels whose source coordinate (float64) lies
    within TIE_BAND of a half-integer."""
    C, H, W = shape
    ang = np.asarray(angles_deg, np.float64) * (np.pi / 180.0)
    yy, xx = np.meshgrid(np.arange(H) - (H - 1) / 2.0, np.arange(W) - (W - 1) / 2.0,
                         indexing="ij")
    c, s = np.cos(ang)[:, None, None], np.sin(ang)[:, None, None]
    src = [c * yy - s * xx + (H - 1) / 2.0, s * yy + c * xx + (W - 1) / 2.0]
    near = np.zeros((len(ang), H, W), bool)
    for v in src:
        near |= np.abs(np.abs(v - np.floor(v)) - 0.5) < TIE_BAND
    return near.reshape(len(ang), H * W)


@pytest.mark.parametrize("shape,B", [((1, 28, 28), 64), ((1, 12, 12), 16)])
def test_rotation_matches_jax_with_its_angles(shape, B):
    """Equal except at tie pixels, which the test counts."""
    C, H, W = shape
    x = _img_batch(B=B, C=C, H=H, W=W, seed=4)
    key = jax.random.PRNGKey(9)
    want = np.asarray(JA.make_rotation_fn(shape)(key, x.numpy()))
    angles = np.array(jax.random.uniform(key, (B,), minval=-10.0, maxval=10.0))
    got = make_rotation_fn(shape)(None, x, torch.from_numpy(angles)).numpy()
    differ = (got != want).reshape(B, C, H * W).any(axis=1)
    assert not (differ & ~_near_half(shape, angles)).any()
    assert differ.sum() <= 0.001 * differ.size
    assert (got != x.numpy()).mean() > 0.05  # the images were rotated


def test_flip_matches_jax_with_its_draws():
    shape, B = (3, 32, 32), 64
    x = _img_batch(B=B, C=3, H=32, W=32, seed=5)
    key = jax.random.PRNGKey(10)
    want = np.asarray(JA.make_flip_fn(shape)(key, x.numpy()))
    flips = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5, (B,))))
    assert 0 < int(flips.sum()) < B
    np.testing.assert_array_equal(make_flip_fn(shape)(None, x, flips).numpy(), want)


@pytest.mark.parametrize("preset,kind", [("tauUnet_mnist", "rotation"),
                                         ("bin_mnist_hollow", "rotation"),
                                         ("tauUnet_cifar10", "flip"),
                                         ("mlp_synthetic", None),
                                         ("protein_maze", None)])
def test_make_augment_fn_gating(preset, kind):
    """DiscreteMNIST and BinMNIST rotate, DiscreteCIFAR10 flips, as JAX
    gates them; off without `data.use_augm`; none for other datasets."""
    cfg = get_preset(preset)
    assert make_augment_fn(cfg) is None
    cfg.data.use_augm = True
    fn = make_augment_fn(cfg)
    jfn = JA.make_augment_fn(cfg)
    assert (fn is None) == (jfn is None) == (kind is None)
    if kind is not None:
        assert fn.__qualname__.startswith(f"make_{kind}_fn")


@pytest.mark.parametrize("device_data", [False, True])
def test_augmented_train_step(device_data):
    """Both step functions augment the batch before the loss, from the step's
    generator: the loss the loss sees is the augmented batch's."""
    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state

    cfg = get_preset("tauUnet_mnist")
    for k, v in {"image_size": 8, "shape": [1, 8, 8], "S": 8, "use_augm": True,
                 "batch_size": 4}.items():
        cfg.data[k] = v
    for k, v in {"concat_dim": 64, "ch": 8, "num_res_blocks": 1, "ch_mult": [1, 2],
                 "num_heads": 2, "attn_resolutions": [4]}.items():
        cfg.model[k] = v
    model = create_model(cfg, device="cpu")
    model.net.init_weights(gen(0))
    tx = get_optimizer(cfg)
    seen = []

    class Recording:
        def calc_loss(self, model, params, generator, batch, **kw):
            seen.append(batch.clone())
            return get_loss(cfg).calc_loss(model, params, generator, batch, **kw)

    augment = make_augment_fn(cfg)
    x = torch.from_numpy(np.random.RandomState(6).randint(0, 8, (4, 64)).astype(np.int32))
    state = create_train_state(dict(model.net.named_parameters()), tx)
    if device_data:
        step = TS.make_device_data_step(model, Recording(), tx, 4, ema_decay=0.999,
                                        augment_fn=augment)
        # seed 8: a draw whose small angles move pixels of the 8x8 images
        state, loss = step(state, x, 8)
        g = TS.step_generator(8, 0, "cpu")
        batch = x[torch.randint(0, 4, (4,), generator=g)]
    else:
        step = TS.make_train_step(model, Recording(), tx, ema_decay=0.999, augment_fn=augment)
        state, loss = step(state, x, 7)
        g, batch = TS.step_generator(7, 0, "cpu"), x
    assert np.isfinite(loss) and state.step == 1
    assert torch.equal(seen[0], augment(g, batch))
    assert not torch.equal(seen[0], batch)
