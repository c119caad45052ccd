"""InceptionV3 pool3 feature extractor (FID).

Counterpart of ctdd_tpu/metrics/inception.py: the torchvision/pytorch-fid
InceptionV3 feature path up to the 2048-d pool3 vector. BasicConv2d =
conv (no bias) + BatchNorm (eps 1e-3, running statistics) + ReLU; blocks
A (x3), B, C (x4), D, E (x2); the average pools leave the padding out of
their counts and Mixed_7c's pool is a max pool, as pytorch-fid's FID
network has them; no aux head.

Parameters carry torchvision's names ("Conv2d_1a_3x3.conv.weight",
"Mixed_5b.branch1x1.bn.running_mean", ...), so the npz that
scripts/convert_inception_weights.py writes (pytorch-fid's
pt_inception-2015-12-05 by default) loads straight into the state dict.
No such npz is in the repository; without one the network runs with
weights drawn from seed 0 (flax's default distributions), which checks the
pipeline but gives no quality number.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.common import flax_init_
from ctdd_tpu_torch.utils.device import resolve_device, tf32_off


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool_kind: str = "avg"):
        super().__init__()
        self.pool_kind = pool_kind  # pytorch-fid's last block pools by max
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool_kind == "max"
                  else _avg_pool(x))
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3Features(nn.Module):
    """(B, 3, H, W) in [0, 1], H and W at least 75 (299 for FID) -> (B,
    2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool_kind="max")

    def forward(self, x):
        x = 2.0 * x - 1.0  # torchvision's normalization, (x - 0.5) / 0.5
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))  # global average pool -> 2048


def inception_npz_family(path: str) -> str:
    """Checkpoint provenance recorded by scripts/convert_inception_weights.py:
    'pytorch-fid' = pt_inception-2015-12-05 (the reference's FID protocol),
    'torchvision' = IMAGENET1K_V1 (not comparable to published FIDs),
    'unknown' = an npz without the marker."""
    with np.load(path) as arrays:
        if "_family" in arrays:
            return str(arrays["_family"])
    return "unknown"


def load_torch_inception_npz(path: str, net: InceptionV3Features,
                             strict: bool = True) -> InceptionV3Features:
    """Copy torchvision-named arrays into `net`'s state dict in place.

    With strict=True (default), raises if a parameter or buffer of `net` has
    no array or an array goes unused (`_`-prefixed metadata and BatchNorm's
    `num_batches_tracked` excepted): a conversion bug would otherwise leave
    layers at their random weights. A shape mismatch always raises."""
    with np.load(path) as f:
        arrays = dict(f)
    meta = {k for k in arrays if k.startswith("_")}
    state = net.state_dict()
    consumed, unmapped = set(), []
    with torch.no_grad():
        for key, target in state.items():
            if key.endswith("num_batches_tracked"):
                continue
            if key not in arrays:
                unmapped.append(key)
                continue
            src = arrays[key]
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"inception npz {key}: shape {src.shape}, "
                                 f"expected {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.asarray(src, np.float32)))
            consumed.add(key)
    leftovers = sorted(set(arrays) - consumed - meta)
    if strict and (unmapped or leftovers):
        raise ValueError(
            f"inception npz mapping incomplete: {len(unmapped)} parameters "
            f"without a source array {unmapped[:5]}..., {len(leftovers)} "
            f"unconsumed arrays {leftovers[:5]}..."
        )
    return net


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) -> (N, 3, 299, 299), bilinear with half-pixel centres
    (`jax.image.resize(..., "bilinear")` on an upsampling)."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)


def inception_network(weights_path: Optional[str] = None, device=None) -> InceptionV3Features:
    """The network in eval mode on `device`: weights from the npz, else drawn
    from seed 0."""
    net = flax_init_(InceptionV3Features(), torch.Generator().manual_seed(0))
    if weights_path:
        load_torch_inception_npz(weights_path, net)
    return net.to(resolve_device(device)).eval()


def inception_pool3_features(weights_path: Optional[str] = None, device=None):
    """fn(images float32 (N, H, W, 3) in [0, 1]) -> (N, 2048) numpy
    features: resized to 299 and run in float32 with TF32 off on `device`
    (the GPU unless the caller passes another)."""
    device = resolve_device(device)
    net = inception_network(weights_path, device)

    def fn(images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
        with torch.no_grad(), tf32_off():
            return net(resize_299(x.permute(0, 3, 1, 2))).cpu().numpy()

    return fn
