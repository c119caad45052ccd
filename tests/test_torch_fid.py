"""Port vs JAX: FID statistics, the lenet, trained-classifier and
InceptionV3 feature nets, the resize to 299 and the strict npz loader.

Flax parameters are carried across by `convert.*_params_from_flax`; both
sides run in float32. Tolerances: lenet features 1e-5 of the largest
|feature| (three convs and a Dense); the trained classifier's features
after 5 Adam steps on the same batches 1e-4 (the updates amplify rounding);
Inception at 75x75 1e-4 of the largest |feature| (94 conv layers; measured
~7e-7); the 28 -> 299 resize 1e-6 absolute; the Fréchet distance and
`evaluate_fid_score` 1e-4 relative (float64 statistics of float32
features).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctdd_tpu.metrics import fid as JF
from ctdd_tpu.metrics import inception as JI
from ctdd_tpu_torch.convert import (
    classifier_params_from_flax, inception_params_from_flax, lenet_params_from_flax,
)
from ctdd_tpu_torch.metrics import fid as TF
from ctdd_tpu_torch.metrics import inception as TI
from tests.test_torch_unet import one_torch_thread  # noqa: F401


class FlaxLeNet(nn.Module):
    """The JAX package's FID conv net (`_lenet_features`,
    `trained_classifier_features`), which it defines inside those functions:
    the same modules in the same order, so `init` at the same key gives the
    same parameters."""

    feature_dim: int = 256
    n_classes: int = 0

    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Conv(32, (3, 3), strides=(2, 2))(x))
        x = nn.relu(nn.Conv(64, (3, 3), strides=(2, 2))(x))
        x = nn.relu(nn.Conv(128, (3, 3), strides=(2, 2))(x))
        feats = nn.Dense(self.feature_dim)(jnp.mean(x, axis=(1, 2)))
        if not self.n_classes:
            return feats
        return feats, nn.Dense(self.n_classes)(nn.relu(feats))


def _images(n, size, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_lenet(params, **kw):
    net = TF.LeNetFeatures(**kw)
    convert = classifier_params_from_flax if kw.get("n_classes") else lenet_params_from_flax
    net.load_state_dict(convert(_np(params["params"]), **kw))
    return net


def _close(got, want, rel):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)
    return err / scale


def test_statistics_match_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(300, 12), rng.randn(250, 12) * 1.3 + 0.2
    imgs = rng.randint(0, 256, (5, 1, 8, 8)).astype(np.uint8)
    assert np.array_equal(TF.preprocess_images(imgs), JF.preprocess_images(imgs))
    (m1, s1), (m2, s2) = TF.activation_statistics(a), TF.activation_statistics(b)
    assert np.array_equal(m1, JF.activation_statistics(a)[0])
    got = TF.calculate_frechet_distance(m1, s1, m2, s2)
    want = JF.calculate_frechet_distance(m1, s1, m2, s2)
    assert abs(got - want) <= 1e-4 * abs(want) and got > 0.1
    assert abs(TF.calculate_frechet_distance(m1, s1, m1, s1)) < 1e-6


@pytest.mark.parametrize("size", [28, 8, 7])
def test_same_padding_is_flax_padding(size):
    """28 -> 14 pads (0, 1), 7 -> 4 pads (1, 1): the shapes of flax's SAME."""
    out = -(-size // 2)
    before, after = TF.same_padding(size, 3, 2)
    assert (size + before + after - 3) // 2 + 1 == out
    assert TF.same_padding(28, 3, 2) == (0, 1) and TF.same_padding(7, 3, 2) == (1, 1)


def test_lenet_features_match_jax_and_symmetric_padding_does_not():
    """JAX's `_lenet_features(seed=0)` against the port's net with the same
    flax parameters at 28x28. The control, a forward with symmetric padding
    (F.conv2d(padding=1)) on the same weights, must miss the tolerance."""
    x = _images(6, 28)
    params = FlaxLeNet().init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    want = JF._lenet_features(seed=0)(x)
    net = _port_lenet(params)
    got = TF.module_features(net, torch.device("cpu"))(x)
    _close(got, want, 1e-5)

    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for conv in (net.conv_0, net.conv_1, net.conv_2):
            h = F.relu(F.conv2d(h, conv.weight, conv.bias, stride=2, padding=1))
        sym = net.dense_0(h.mean(dim=(2, 3))).numpy()
    assert np.abs(sym - want).max() > 1e-3 * np.abs(want).max()


def test_trained_classifier_matches_jax():
    """5 Adam steps on the same batches (RandomState(seed) on both sides)
    from the same flax parameters, then the features of held-out images."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (64, 1, 8, 8)).astype(np.uint8)
    labels = (images.reshape(64, -1).mean(1) > 127).astype(np.int32)
    x_all = JF.preprocess_images(images)
    kw = dict(feature_dim=32, n_classes=2)
    params = FlaxLeNet(**kw).init(jax.random.PRNGKey(0), jnp.asarray(x_all[:2]))
    fn = JF.trained_classifier_features(images, labels, seed=0, steps=5, batch=16, **kw)
    net = TF.train_classifier(_port_lenet(params, **kw), x_all, labels, seed=0, steps=5,
                              batch=16, device="cpu")
    test = _images(10, 8, seed=1)
    got = TF.module_features(net, torch.device("cpu"))(test)
    _close(got, fn(test), 1e-4)
    # the 5 steps moved the features
    moved = TF.module_features(_port_lenet(params, **kw), torch.device("cpu"))(test)
    assert np.abs(moved - got).max() > 1e-3 * np.abs(got).max()


def _fill(rng, kind, shape, fan_in):
    """He-scaled conv kernels and BatchNorm near identity: activations stay
    of order 1 through the 94 layers."""
    if kind == "kernel":
        return (rng.standard_normal(shape) * np.sqrt(2 / fan_in)).astype(np.float32)
    noise = rng.standard_normal(shape)
    if kind == "var":
        return (1.0 + 0.2 * np.abs(noise)).astype(np.float32)
    return ({"scale": 1.0}.get(kind, 0.0) + 0.1 * noise).astype(np.float32)


def _random_inception_variables(seed=0):
    """flax InceptionV3 variables (shapes at 75x75, the smallest size its
    stem takes), seeded."""
    shapes = jax.eval_shape(lambda: JI.InceptionV3Features().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3))))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: _fill(rng, path[-1].key, a.shape, np.prod(a.shape[:-1])), shapes)


@pytest.fixture(scope="module")
def inception_variables():
    return _random_inception_variables()


def test_inception_matches_jax_at_75(inception_variables):
    x = _images(2, 75)
    want = np.asarray(jax.jit(JI.InceptionV3Features().apply)(inception_variables,
                                                               jnp.asarray(x)))
    net = TI.InceptionV3Features().eval()
    net.load_state_dict(inception_params_from_flax(_np(inception_variables)), strict=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048)
    _close(got, want, 1e-4)
    assert np.abs(want).max() > 0.1


def test_resize_to_299_matches_jax():
    x = _images(2, 28)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear"))
    got = TI.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _torchvision_arrays(seed=0):
    """A torchvision-named npz body for the port's network, seeded."""
    rng = np.random.default_rng(seed)
    kinds = {"conv.weight": "kernel", "bn.weight": "scale", "bn.bias": "bias",
             "bn.running_mean": "mean", "bn.running_var": "var"}
    return {k: _fill(rng, kinds[k.split(".", k.count(".") - 1)[-1]], tuple(v.shape),
                     np.prod(v.shape[1:]))
            for k, v in TI.InceptionV3Features().state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_inception_npz_loads_strictly(tmp_path):
    """Every parameter and buffer loads (94 BasicConv2d layers, 5 arrays
    each), the family marker reads back; a missing array, an unused one and
    a misshapen one each raise."""
    arrays = _torchvision_arrays()
    assert len(arrays) == 94 * 5
    path = tmp_path / "inception.npz"
    np.savez(path, _family=np.asarray("pytorch-fid"), **arrays)
    assert TI.inception_npz_family(str(path)) == "pytorch-fid"
    net = TI.load_torch_inception_npz(str(path), TI.InceptionV3Features())
    sd = net.state_dict()
    for name in ("Conv2d_1a_3x3.conv.weight", "Mixed_7c.branch_pool.bn.running_mean",
                 "Mixed_6e.branch7x7dbl_5.bn.weight"):
        assert np.array_equal(sd[name].numpy(), arrays[name])

    missing = dict(arrays)
    missing.pop("Mixed_7b.branch1x1.conv.weight")
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(ValueError, match="without a source array"):
        TI.load_torch_inception_npz(str(tmp_path / "missing.npz"), TI.InceptionV3Features())
    np.savez(tmp_path / "extra.npz", **arrays, **{"fc.weight": np.zeros((10, 2048), np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        TI.load_torch_inception_npz(str(tmp_path / "extra.npz"), TI.InceptionV3Features())
    bad = dict(arrays)
    bad["Conv2d_1a_3x3.conv.weight"] = bad["Conv2d_1a_3x3.conv.weight"][:, :, :2]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="shape"):
        TI.load_torch_inception_npz(str(tmp_path / "bad.npz"), TI.InceptionV3Features())
    np.savez(tmp_path / "old.npz", x=np.zeros(3))
    assert TI.inception_npz_family(str(tmp_path / "old.npz")) == "unknown"


def test_inception_convert_and_npz_agree(tmp_path, inception_variables):
    """The flax converter and the npz loader fill the same state dict, and
    the converter refuses a leaf it does not know."""
    sd = inception_params_from_flax(_np(inception_variables))
    np.savez(tmp_path / "w.npz", **{k: v.numpy() for k, v in sd.items()})
    net = TI.load_torch_inception_npz(str(tmp_path / "w.npz"), TI.InceptionV3Features())
    for k, v in sd.items():
        assert torch.equal(net.state_dict()[k], v), k
    bad = _np(inception_variables)
    bad["params"]["Mixed_5b"]["extra"] = {"conv": {"kernel": np.zeros((1, 1, 1, 1))}}
    with pytest.raises(KeyError):
        inception_params_from_flax(bad)


def test_inception_pool3_features_pipeline(tmp_path):
    """The feature function at 28x28 inputs: resize to 299, the network from
    the npz, float32 on the CPU."""
    np.savez(tmp_path / "w.npz", **_torchvision_arrays(1))
    x = _images(2, 28)
    got = TI.inception_pool3_features(str(tmp_path / "w.npz"), device="cpu")(x)
    net = TI.inception_network(str(tmp_path / "w.npz"), device="cpu")
    with torch.no_grad():
        want = net(TI.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2))).numpy()
    assert got.shape == (2, 2048) and np.isfinite(got).all()
    assert np.array_equal(got, want)


def test_evaluate_fid_score_matches_jax():
    """One feature function per side, the lenet net with the same flax
    parameters: the FIDs of the same image sets agree."""
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (96, 1, 16, 16)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-40, 40, a.shape), 0, 255).astype(np.uint8)
    params = FlaxLeNet(feature_dim=32).init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))
    jfn = jax.jit(lambda x: FlaxLeNet(feature_dim=32).apply(params, x))
    port = TF.evaluate_fid_score(a, b, TF.module_features(_port_lenet(params, feature_dim=32),
                                                          torch.device("cpu")), device="cpu")
    want = JF.evaluate_fid_score(a, b, lambda x: np.asarray(jfn(jnp.asarray(x))))
    assert abs(port - want) <= 1e-4 * abs(want) and want > 0


def test_fid_pipeline_discriminates():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (64, 1, 8, 8)).astype(np.uint8)
    assert TF.evaluate_fid_score(a, a.copy(), "lenet", device="cpu") < 1e-3
    assert TF.evaluate_fid_score(a, np.zeros_like(a), "lenet", device="cpu") > 1e-3
