"""Image datasets: DiscreteMNIST, DiscreteCIFAR10, BinMNIST; and
LakhPianoroll.

Counterpart of ctdd_tpu/data/images.py. DiscreteMNIST reads the npz at
cfg.data.location (`x_train`/`y_train` or `images`/`labels`, uint8
images); DiscreteCIFAR10 an npz with `x_train`/`y_train` or
`images`/`labels`, NCHW or NHWC; BinMNIST a binarized (N, 784) or
(N, 1, 28, 28) npy, else DiscreteMNIST thresholded at 127. With no file
there, each falls back to sklearn's 8x8 digits upsampled to the image size
(grey, repeated over CIFAR10's three channels) where sklearn is installed,
as the JAX package does, and otherwise raises and names the missing file.
`data.random_flips` is read by neither package. LakhPianoroll reads its
(N, L) npy, or makes the seeded stand-in of data/pianoroll.py where the
file is absent, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.data.loaders import ArrayDataset


def _load_mnist_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as f:
        if "x_train" in f:
            return f["x_train"], f.get("y_train", np.zeros(len(f["x_train"])))
        if "images" in f:
            return f["images"], f.get("labels", np.zeros(len(f["images"])))
    raise KeyError(f"unrecognized npz keys in {path}")


def _digits_standin(n: int, image_size: int, path: str,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn 8x8 digits -> (n, image_size, image_size) uint8 in [0, 255];
    without sklearn a FileNotFoundError names `path`, the missing file."""
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        raise FileNotFoundError(
            f"no dataset file at {path!r} (data.location) and no sklearn for "
            "the digits stand-in: put the file there or set data.location"
        ) from None

    X, y = load_digits(return_X_y=True)
    imgs = (X.reshape(-1, 8, 8) * (255.0 / 16.0)).astype(np.uint8)
    reps = int(np.ceil(image_size / 8))
    imgs = np.repeat(np.repeat(imgs, reps, axis=1), reps, axis=2)
    imgs = imgs[:, :image_size, :image_size]
    idx = np.random.RandomState(seed).randint(0, len(imgs), size=n)
    return imgs[idx], y[idx]


@registry.datasets.register(name="DiscreteMNIST")
def discrete_mnist(cfg, root: Optional[str] = None) -> ArrayDataset:
    """Ints 0..255, shape (N, 1, H, W)."""
    size = cfg.data.image_size
    path = root or cfg.data.get("location", "")
    candidates = [path, os.path.join(path or ".", "mnist.npz")]
    imgs = labels = None
    for c in candidates:
        if c and os.path.isfile(c) and c.endswith(".npz"):
            imgs, labels = _load_mnist_npz(c)
            break
    if imgs is None:
        imgs, labels = _digits_standin(int(cfg.data.get("num_samples", 8192)), size, path)
    if imgs.shape[-1] != size:
        reps = int(np.ceil(size / imgs.shape[-1]))
        imgs = np.repeat(np.repeat(imgs, reps, axis=1), reps, axis=2)[:, :size, :size]
    data = imgs[:, None, :, :].astype(np.uint8)  # (N, 1, H, W)
    return ArrayDataset(data, np.asarray(labels).astype(np.int32))


@registry.datasets.register(name="DiscreteCIFAR10")
def discrete_cifar10(cfg, root: Optional[str] = None) -> ArrayDataset:
    """Ints 0..255, shape (N, 3, 32, 32)."""
    path = root or cfg.data.get("location", "")
    if path and os.path.isfile(path):
        with np.load(path) as f:
            imgs = f["x_train"] if "x_train" in f else f["images"]
            labels = f["y_train"] if "y_train" in f else f.get("labels")
        if imgs.shape[-1] == 3:  # NHWC -> NCHW
            imgs = imgs.transpose(0, 3, 1, 2)
    else:
        grey, labels = _digits_standin(int(cfg.data.get("num_samples", 8192)), 32, path)
        imgs = np.repeat(grey[:, None, :, :], 3, axis=1)
    return ArrayDataset(imgs.astype(np.uint8), np.asarray(labels).astype(np.int32))


@registry.datasets.register(name="BinMNIST")
def bin_mnist(cfg, root: Optional[str] = None) -> ArrayDataset:
    """Binarized MNIST {0, 1}, (N, 1, H, W): the npy at cfg.data.location
    (no labels), else DiscreteMNIST (from cfg.data.location) above 127."""
    path = root or cfg.data.get("location", "")
    if path and os.path.isfile(path) and path.endswith(".npy"):
        data = np.load(path)
        size = cfg.data.image_size
        return ArrayDataset(data.reshape(len(data), 1, size, size).astype(np.uint8))
    base = discrete_mnist(cfg, root=None)
    return ArrayDataset((base.data > 127).astype(np.uint8), base.labels)


@registry.datasets.register(name="LakhPianoroll")
def lakh_pianoroll(cfg, root: Optional[str] = None) -> ArrayDataset:
    """(N, L) int32: the npy at cfg.data.location, else the stand-in of
    `data.num_samples` rows (8192 by default) from `data.seed` (0)."""
    path = root or cfg.data.location
    if path and os.path.isfile(path):
        return ArrayDataset(np.load(path).astype(np.int32))
    from ctdd_tpu_torch.data.pianoroll import generate_standin

    data = generate_standin(int(cfg.data.get("num_samples", 8192)),
                            length=int(cfg.data.shape[0]),
                            seed=int(cfg.data.get("seed", 0)))
    return ArrayDataset(data)
