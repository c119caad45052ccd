"""On-device data augmentation inside the train step.

Counterpart of ctdd_tpu/data/augment.py: with `data.use_augm`, a fresh
random transform per item per step on the batch where it lies, as the
reference's torchvision transforms do per item: RandomRotation((-10, 10))
for DiscreteMNIST and BinMNIST, RandomHorizontalFlip for DiscreteCIFAR10.

The rotation resamples nearest-neighbour (torchvision's default), which
keeps the states discrete; pixels from outside the frame are 0. Its source
coordinates are rounded half to even from float32 cos and sin of the angle,
which may differ by an ulp between devices and frameworks: a pixel whose
source coordinate lies within ~1e-5 of a half-integer may then come from its
neighbour.

Each transform is `aug(generator, batch, draws=None)` on a flat int batch
(B, C*H*W); `draws` (the angles in degrees, or the flips as bools, (B,))
are drawn from `generator` when not given.
"""

from __future__ import annotations

import math

import torch


def make_rotation_fn(shape, max_deg: float = 10.0):
    """Per-item random rotation in (-max_deg, max_deg)."""
    C, H, W = shape

    def aug(generator, batch, draws=None):
        B, dev = batch.shape[0], batch.device
        if draws is None:
            draws = torch.rand(B, generator=generator, device=dev) * (2 * max_deg) - max_deg
        ang = draws.to(device=dev, dtype=torch.float32) * (math.pi / 180.0)
        cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev) - cy,
                                torch.arange(W, dtype=torch.float32, device=dev) - cx,
                                indexing="ij")
        cos = torch.cos(ang)[:, None, None]
        sin = torch.sin(ang)[:, None, None]
        # the inverse map: destination (yy, xx) pulls from source coordinates
        iy = torch.round(cos * yy - sin * xx + cy).long()
        ix = torch.round(sin * yy + cos * xx + cx).long()
        inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        flat_idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, 1, H * W)
        img = batch.reshape(B, C, H * W)
        rot = torch.gather(img, 2, flat_idx.expand(B, C, H * W))
        rot = torch.where(inb.reshape(B, 1, H * W), rot, torch.zeros_like(rot))
        return rot.reshape(batch.shape).to(batch.dtype)

    return aug


def make_flip_fn(shape):
    """Per-item random horizontal flip (p = 0.5)."""
    C, H, W = shape

    def aug(generator, batch, draws=None):
        B, dev = batch.shape[0], batch.device
        if draws is None:
            draws = torch.rand(B, generator=generator, device=dev) < 0.5
        img = batch.reshape(B, C, H, W)
        out = torch.where(draws.to(dev).reshape(B, 1, 1, 1), img.flip(-1), img)
        return out.reshape(batch.shape).to(batch.dtype)

    return aug


def make_augment_fn(cfg):
    """The reference's use_augm transform for this dataset, or None."""
    if not cfg.data.get("use_augm", False):
        return None
    shape = tuple(cfg.data.get("shape", ()))
    if len(shape) != 3:
        return None
    name = cfg.data.name
    if name in ("DiscreteMNIST", "BinMNIST"):
        return make_rotation_fn(shape)
    if name == "DiscreteCIFAR10":
        return make_flip_fn(shape)
    return None
