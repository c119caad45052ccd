"""Port vs JAX: the synthetic 2D data, its Gray-code binarization, the
`SyntheticData` dataset and the host batch iterator. numpy on both sides,
from the same `RandomState`: every array must be bit-identical."""

import numpy as np
import pytest

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.data import loaders as jax_loaders
from ctdd_tpu.data import synthetic as J
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.data import loaders as L
from ctdd_tpu_torch.data import synthetic as T


@pytest.mark.parametrize("name", ["2spirals", "8gaussians", "pinwheel", "checkerboard",
                                  "line", "cos"])
def test_inf_train_gen_bit_identical(name):
    a = J.inf_train_gen(name, np.random.RandomState(3), 1000)
    b = T.inf_train_gen(name, np.random.RandomState(3), 1000)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("binmode", ["gray", "normal"])
@pytest.mark.parametrize("name", ["2spirals", "8gaussians", "pinwheel", "checkerboard"])
def test_generate_dataset_bit_identical(name, binmode, tmp_path):
    a, meta_a = J.generate_dataset(name, 2000, 32, binmode, seed=0)
    b, meta_b = T.generate_dataset(name, 2000, 32, binmode, seed=0,
                                   save_path=str(tmp_path / "d.npy"))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert meta_a == meta_b
    assert np.array_equal(np.load(tmp_path / "d.npy"), b.astype(np.int8))


@pytest.mark.parametrize("binmode", ["gray", "normal"])
def test_float2bin_bin2float_match_jax(binmode):
    rng = np.random.RandomState(0)
    floats = rng.uniform(-4.4, 4.4, (500, 2))  # within the calibrated range
    scale = T.OnlineToyDataset("2spirals").int_scale
    bits = T.float2bin(floats, 32, scale, binmode)
    assert np.array_equal(bits, J.float2bin(floats, 32, scale, binmode))
    assert set(np.unique(bits)) <= {0, 1}
    back = T.bin2float(bits, 32, scale, binmode)
    assert np.array_equal(back, J.bin2float(bits, 32, scale, binmode))
    # truncation toward 0 at 1 / int_scale
    assert np.abs(back - floats).max() <= 1.0 / scale


def test_synthetic_data_entry(tmp_path):
    """Generated from seed 0 where data.location does not exist (the JAX
    entry's rows, bit for bit), loaded where it does."""
    cfg, jcfg = get_preset("mlp_synthetic"), jax_get_preset("mlp_synthetic")
    for c in (cfg, jcfg):
        c.data.num_samples = 3000
        c.data.location = str(tmp_path / "missing.npy")
    ds = L.get_dataset(cfg)
    assert ds.data.shape == (3000, 32) and ds.data.dtype == np.int32 and ds.labels is None
    assert np.array_equal(ds.data, jax_loaders.get_dataset(jcfg).data)
    path = tmp_path / "data.npy"
    np.save(path, ds.data[:100].astype(np.int8))
    cfg.data.location = str(path)
    assert np.array_equal(L.get_dataset(cfg).data, ds.data[:100])


@pytest.mark.parametrize("shuffle", [True, False])
def test_iterate_batches_match_jax(shuffle):
    """The same batches as the JAX iterator over three epochs, the last
    partial batch of each dropped."""
    ds = L.ArrayDataset(np.arange(23)[:, None], np.arange(23) % 3)
    mine = L.iterate_batches(ds, 5, shuffle=shuffle, seed=4)
    theirs = jax_loaders.iterate_batches(jax_loaders.ArrayDataset(ds.data, ds.labels), 5,
                                         shuffle=shuffle, seed=4)
    for _ in range(12):
        (x, y), (jx, jy) = next(mine), next(theirs)
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert len(x) == 5


@pytest.mark.parametrize("binmode", ["gray", "normal"])
def test_dataset_cli_writes_jax_bytes(binmode, tmp_path):
    """`python -m ctdd_tpu_torch.data.synthetic` writes the .npy file JAX's
    `generate_dataset` writes for the same flags and seed, byte for byte;
    `--plot` draws the decoded floats."""
    import subprocess
    import sys

    J.generate_dataset("pinwheel", 3000, 32, binmode, seed=7,
                       save_path=str(tmp_path / "jax.npy"))
    out = subprocess.run(
        [sys.executable, "-m", "ctdd_tpu_torch.data.synthetic", "--type", "pinwheel",
         "--num-samples", "3000", "--binmode", binmode, "--seed", "7",
         "--out", str(tmp_path / "port.npy"), "--plot", str(tmp_path / "plot.png")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "3000 samples -> " in out.stdout
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    assert (tmp_path / "plot.png").read_bytes().startswith(b"\x89PNG")
