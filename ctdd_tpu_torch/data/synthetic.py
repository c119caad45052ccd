"""Synthetic 2D toy distributions and their Gray-code binarization.

The port's own copy of ctdd_tpu/data/synthetic.py (numpy only): given the
same `RandomState`, every function returns bit-identical arrays.
`inf_train_gen` samples a 2D distribution (sklearn is imported only by the
swissroll, circles and moons branches), `OnlineToyDataset` wraps it with the
reference's int_scale calibration, `float2bin`/`bin2float` map (N, 2) floats
to (N, D) bits and back with vectorized integer bit-math, and
`generate_dataset` makes a binarized dataset, and `python -m
ctdd_tpu_torch.data.synthetic` writes one to an .npy file (JAX's CLI: the
same flags, the same bytes for the same seed).
"""

from __future__ import annotations

import os

import numpy as np


def inf_train_gen(data: str, rng=None, batch_size: int = 200) -> np.ndarray:
    """Sample a batch of 2D synthetic data (ref synthetic.py:24-121)."""
    if rng is None:
        rng = np.random.RandomState()

    if data == "swissroll":
        import sklearn.datasets

        out = sklearn.datasets.make_swiss_roll(
            n_samples=batch_size, noise=1.0, random_state=rng
        )[0]
        return out.astype("float32")[:, [0, 2]] / 5.0

    if data == "circles":
        import sklearn.datasets

        out = sklearn.datasets.make_circles(
            n_samples=batch_size, factor=0.5, noise=0.08, random_state=rng
        )[0]
        return out.astype("float32") * 3.0

    if data == "moons":
        import sklearn.datasets

        out = sklearn.datasets.make_moons(
            n_samples=batch_size, noise=0.1, random_state=rng
        )[0]
        return out.astype("float32") * 2.0 + np.array([-1.0, -0.2], np.float32)

    if data == "8gaussians":
        scale = 4.0
        centers = np.array(
            [
                (1, 0), (-1, 0), (0, 1), (0, -1),
                (1 / np.sqrt(2), 1 / np.sqrt(2)),
                (1 / np.sqrt(2), -1 / np.sqrt(2)),
                (-1 / np.sqrt(2), 1 / np.sqrt(2)),
                (-1 / np.sqrt(2), -1 / np.sqrt(2)),
            ],
            np.float32,
        ) * scale
        points = rng.randn(batch_size, 2).astype(np.float32) * 0.5
        idx = rng.randint(8, size=batch_size)
        return (points + centers[idx]) / 1.414

    if data == "pinwheel":
        radial_std, tangential_std = 0.3, 0.1
        num_classes, rate = 5, 0.25
        num_per_class = batch_size // num_classes
        rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
        features = rng.randn(num_classes * num_per_class, 2) * np.array(
            [radial_std, tangential_std]
        )
        features[:, 0] += 1.0
        labels = np.repeat(np.arange(num_classes), num_per_class)
        angles = rads[labels] + rate * np.exp(features[:, 0])
        rotations = np.stack(
            [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)]
        )
        rotations = np.reshape(rotations.T, (-1, 2, 2))
        return 2 * rng.permutation(np.einsum("ti,tij->tj", features, rotations))

    if data == "2spirals":
        n = np.sqrt(rng.rand(batch_size // 2, 1)) * 540 * (2 * np.pi) / 360
        d1x = -np.cos(n) * n + rng.rand(batch_size // 2, 1) * 0.5
        d1y = np.sin(n) * n + rng.rand(batch_size // 2, 1) * 0.5
        x = np.vstack((np.hstack((d1x, d1y)), np.hstack((-d1x, -d1y)))) / 3.0
        return x + rng.randn(*x.shape) * 0.1

    if data == "checkerboard":
        x1 = rng.rand(batch_size) * 4 - 2
        x2_ = rng.rand(batch_size) - rng.randint(0, 2, batch_size) * 2
        x2 = x2_ + (np.floor(x1) % 2)
        return np.concatenate([x1[:, None], x2[:, None]], 1) * 2

    if data == "line":
        x = rng.rand(batch_size) * 5 - 2.5
        return np.stack((x, x), 1)
    if data == "cos":
        x = rng.rand(batch_size) * 5 - 2.5
        return np.stack((x, np.sin(x) * 2.5), 1)
    raise NotImplementedError(data)


class OnlineToyDataset:
    """inf_train_gen wrapper with the reference's int_scale calibration
    (synthetic.py:124-143)."""

    def __init__(self, data_name: str, seed: int | None = None):
        self.dim = 2
        self.data_name = data_name
        self.rng = np.random.RandomState(seed)
        calib = inf_train_gen(data_name, np.random.RandomState(1), 5000)
        self.f_scale = np.max(np.abs(calib)) + 1
        self.int_scale = 2**15 / (self.f_scale + 1)

    def gen_batch(self, batch_size: int) -> np.ndarray:
        return inf_train_gen(self.data_name, self.rng, batch_size)


# ---------------------------------------------------------------------------
# Vectorized Gray-code binarization
# ---------------------------------------------------------------------------
# Encoding layout per coordinate (discrete_dim//2 bits): [sign] + bits(code),
# where code = binary(m) in 'normal' mode or gray(m) = m ^ (m >> 1) in 'gray'
# mode — the mapping the reference builds with string tables
# (synthetic.py:164-224).


def _to_bits(vals: np.ndarray, width: int) -> np.ndarray:
    shifts = np.arange(width - 1, -1, -1)
    return ((vals[..., None] >> shifts) & 1).astype(np.int32)


def _from_bits(bits: np.ndarray) -> np.ndarray:
    width = bits.shape[-1]
    shifts = np.arange(width - 1, -1, -1)
    return np.sum(bits.astype(np.int64) << shifts, axis=-1)


def _gray_encode(m: np.ndarray) -> np.ndarray:
    return m ^ (m >> 1)


def _gray_decode(g: np.ndarray) -> np.ndarray:
    m = g.copy()
    shift = 1
    while shift < 64:
        m ^= m >> shift
        shift <<= 1
    return m


def float2bin(
    samples: np.ndarray, discrete_dim: int, int_scale: float, binmode: str = "gray"
) -> np.ndarray:
    """(N, 2) floats -> (N, discrete_dim) bits (ref synthetic.py:175-182)."""
    b = discrete_dim // 2 - 1
    scaled = samples * int_scale
    sign = (scaled < 0).astype(np.int64)  # '1' prefix for negatives
    mag = np.abs(scaled).astype(np.int64)  # int() truncation, like the ref
    mag = np.minimum(mag, (1 << b) - 1)
    code = _gray_encode(mag) if binmode == "gray" else mag
    bits = np.concatenate([sign[..., None], _to_bits(code, b)], axis=-1)  # (N,2,b+1)
    return bits.reshape(samples.shape[0], discrete_dim).astype(np.int32)


def bin2float(
    samples: np.ndarray, discrete_dim: int, int_scale: float, binmode: str = "gray"
) -> np.ndarray:
    """(N, discrete_dim) bits -> (N, 2) floats (ref synthetic.py:185-198)."""
    b = discrete_dim // 2 - 1
    bits = samples.reshape(samples.shape[0], 2, b + 1)
    sign = 1 - 2 * bits[..., 0].astype(np.int64)
    code = _from_bits(bits[..., 1:])
    mag = _gray_decode(code) if binmode == "gray" else code
    return (sign * mag).astype(np.float64) / int_scale


def generate_dataset(
    data_type: str,
    num_samples: int,
    discrete_dim: int = 32,
    binmode: str = "gray",
    seed: int | None = None,
    save_path: str | None = None,
):
    """Generate a binarized synthetic dataset (ref synthetic.py:285-317 CLI)."""
    db = OnlineToyDataset(data_type, seed=seed)
    raw = db.gen_batch(num_samples)
    data = float2bin(raw, discrete_dim, db.int_scale, binmode)
    meta = {"int_scale": float(db.int_scale), "plot_size": float(db.f_scale)}
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        np.save(save_path, data.astype(np.int8))
    return data, meta


def _main(argv=None):
    """Standalone dataset-generator CLI.

    python -m ctdd_tpu_torch.data.synthetic --type 2spirals --num-samples 100000 \\
        --out DataSynthetic/data_2spirals.npy [--plot samples.png]
    """
    import argparse

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--type", required=True,
                    help="swissroll|circles|moons|8gaussians|pinwheel|"
                         "2spirals|checkerboard|line|cos")
    ap.add_argument("--num-samples", type=int, default=100000)
    ap.add_argument("--discrete-dim", type=int, default=32)
    ap.add_argument("--binmode", default="gray", choices=["gray", "normal"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help=".npy output path")
    ap.add_argument("--plot", default=None,
                    help="optional scatter plot of the decoded floats (needs matplotlib)")
    args = ap.parse_args(argv)

    data, meta = generate_dataset(
        args.type, args.num_samples, discrete_dim=args.discrete_dim,
        binmode=args.binmode, seed=args.seed, save_path=args.out,
    )
    print(f"{data.shape[0]} samples -> {args.out} "
          f"(D={data.shape[1]}, int_scale={meta['int_scale']:.4f})")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        f = bin2float(data[:10000].astype(np.int32), args.discrete_dim,
                      meta["int_scale"], args.binmode)
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(f[:, 0], f[:, 1], s=1, alpha=0.4)
        ax.set_title(args.type)
        fig.savefig(args.plot, dpi=120)
        plt.close(fig)
        print(f"plot -> {args.plot}")


if __name__ == "__main__":
    _main()
