"""FID: the Fréchet distance between feature distributions.

Counterpart of ctdd_tpu/metrics/fid.py. The statistics are the same numpy
and scipy code in float64 on the host (`preprocess_images`,
`calculate_frechet_distance`, `activation_statistics`); the feature nets are
`nn.Module`s on the device, run in float32 with TF32 off:

- "inception": InceptionV3 pool3 (metrics/inception.py), with weights from a
  local npz; random weights without one.
- "lenet": a small conv net with weights drawn from a seed, a relative
  quality signal only.
- `trained_classifier_features`: the same conv trunk trained as a
  classifier on the eval dataset.
- any callable(images float32 (N, H, W, 3) in [0, 1]) -> (N, F) features.

A feature function takes and returns numpy arrays (NHWC in, (N, F) out), as
on the JAX side, so one callable works with both packages.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from scipy import linalg

from ctdd_tpu_torch.networks.common import flax_init_
from ctdd_tpu_torch.utils.device import resolve_device, tf32_off


def preprocess_images(images: np.ndarray) -> np.ndarray:
    """uint8/float (N, C, H, W) or (N, H, W) -> float32 (N, H, W, 3) in [0,1]."""
    x = np.asarray(images, np.float32)
    if x.ndim == 3:
        x = x[:, None, :, :]
    if x.max() > 1.0 + 1e-6:
        x = x / 255.0
    x = np.transpose(x, (0, 2, 3, 1))
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """The reference's FID formula (mnist_fid.py:57-104), in float64."""
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # scipy >= 1.16 deprecates disp= and returns just the array
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if isinstance(covmean, tuple):
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return (
        diff.dot(diff)
        + np.trace(sigma1)
        + np.trace(sigma2)
        - 2 * np.trace(covmean)
    )


def activation_statistics(features: np.ndarray):
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """flax's (TensorFlow's) "SAME" padding of one axis, (before, after): the
    output has ceil(size / stride) entries and the odd pixel goes after, so
    28 -> 14 at stride 2 pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class LeNetFeatures(nn.Module):
    """Three 3x3 stride-2 convs (32, 64, 128 channels, flax's SAME padding)
    with ReLU, a spatial mean and a Dense to `feature_dim`; with
    `n_classes`, a classifier head on ReLU(features) too. Submodules are
    named after the flax modules' (Conv_0 -> conv_0, ...)."""

    def __init__(self, feature_dim: int = 256, n_classes: Optional[int] = None):
        super().__init__()
        self.conv_0 = nn.Conv2d(3, 32, 3, stride=2)
        self.conv_1 = nn.Conv2d(32, 64, 3, stride=2)
        self.conv_2 = nn.Conv2d(64, 128, 3, stride=2)
        self.dense_0 = nn.Linear(128, feature_dim)
        self.dense_1 = nn.Linear(feature_dim, n_classes) if n_classes else None

    def forward(self, x: torch.Tensor):
        """(N, 3, H, W) -> features, or (features, logits) with a head."""
        for conv in (self.conv_0, self.conv_1, self.conv_2):
            (top, bottom), (left, right) = (same_padding(s, 3, 2) for s in x.shape[-2:])
            x = F.relu(conv(F.pad(x, (left, right, top, bottom))))
        feats = self.dense_0(x.mean(dim=(2, 3)))
        if self.dense_1 is None:
            return feats
        return feats, self.dense_1(F.relu(feats))


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device).permute(0, 3, 1, 2)


def module_features(net: nn.Module, device) -> Callable:
    """fn(images float32 (N, H, W, 3)) -> (N, F) numpy features of `net`
    (its first output where it returns two), float32 with TF32 off."""
    net.eval()

    def fn(images: np.ndarray) -> np.ndarray:
        with torch.no_grad(), tf32_off():
            out = net(_nchw(images, device))
        return (out[0] if isinstance(out, tuple) else out).float().cpu().numpy()

    return fn


def _lenet_features(seed: int = 0, feature_dim: int = 256, device=None) -> Callable:
    """The conv feature net with weights drawn from `seed` (flax's default
    distributions, from a torch.Generator): a cheap FID stand-in."""
    device = resolve_device(device)
    net = flax_init_(LeNetFeatures(feature_dim), torch.Generator().manual_seed(seed))
    return module_features(net.to(device), device)


def train_classifier(net: LeNetFeatures, images: np.ndarray, labels: np.ndarray,
                     seed: int = 0, steps: int = 500, batch: int = 256,
                     device=None) -> LeNetFeatures:
    """Train `net` (with a classifier head) on preprocessed images (N, H, W,
    3) by softmax cross-entropy: Adam at 1e-3 with optax's defaults (b1 0.9,
    b2 0.999, eps 1e-8), `steps` batches of `batch` drawn by
    `RandomState(seed)`, float32 with TF32 off. Returns `net`."""
    device = resolve_device(device)
    net = net.to(device).train()
    x_all = _nchw(images, device)
    y_all = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.RandomState(seed)
    with tf32_off():
        for _ in range(steps):
            idx = torch.from_numpy(rng.randint(0, len(x_all), size=batch)).to(device)
            _, logits = net(x_all[idx])
            loss = F.cross_entropy(logits, y_all[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return net


def trained_classifier_features(
    images: np.ndarray, labels: np.ndarray, seed: int = 0,
    steps: int = 500, batch: int = 256, feature_dim: int = 256,
    n_classes: int = 10, device=None,
) -> Callable:
    """Features of the conv trunk trained as a classifier on the eval
    dataset: random-conv features saturate on small stand-in datasets, these
    keep resolving quality differences. Deterministic in (seed, steps, data)
    up to the device's reduction order."""
    net = flax_init_(LeNetFeatures(feature_dim, n_classes), torch.Generator().manual_seed(seed))
    net = train_classifier(net, preprocess_images(images), labels, seed=seed, steps=steps,
                           batch=batch, device=device)
    return module_features(net, resolve_device(device))


def get_feature_fn(kind="lenet", weights_path: Optional[str] = None, device=None) -> Callable:
    if callable(kind):
        return kind
    if kind == "lenet":
        return _lenet_features(device=device)
    if kind == "inception":
        from ctdd_tpu_torch.metrics.inception import inception_pool3_features

        return inception_pool3_features(weights_path, device=device)
    raise ValueError(f"unknown feature extractor {kind}")


def get_activations(images: np.ndarray, feature_fn: Callable,
                    batch_size: int = 128) -> np.ndarray:
    """Batched feature extraction (ref mnist_fid.py:21-54)."""
    x = preprocess_images(images)
    feats = []
    for s in range(0, len(x), batch_size):
        feats.append(np.asarray(feature_fn(x[s : s + batch_size])))
    return np.concatenate(feats, axis=0)


def evaluate_fid_score(
    images1: np.ndarray,
    images2: np.ndarray,
    feature_kind="lenet",
    batch_size: int = 128,
    weights_path: Optional[str] = None,
    device=None,
) -> float:
    """FID between two image sets (ref mnist_fid.py:156-193); the feature
    net runs on `device` (the GPU unless the caller passes another)."""
    fn = get_feature_fn(feature_kind, weights_path, device=device)
    f1 = get_activations(images1, fn, batch_size)
    f2 = get_activations(images2, fn, batch_size)
    mu1, s1 = activation_statistics(f1)
    mu2, s2 = activation_statistics(f2)
    return float(calculate_frechet_distance(mu1, s1, mu2, s2))
