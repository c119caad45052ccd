"""PNG files from uint8 pixel arrays, with the standard library alone
(`zlib`, `struct`), so that grids reach disk where matplotlib is missing.

`encode_png` writes 8-bit grayscale (H, W) or RGB (H, W, 3) images, every
row with filter type 0; `decode_png` reads back what it writes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (grayscale, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """The PNG bytes of a uint8 (H, W) or (H, W, 3) array."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {pixels.dtype}")
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    if pixels.ndim != 3 or pixels.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG pixels must be (H, W) or (H, W, 3), got {pixels.shape}")
    h, w, c = pixels.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
    return path


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG that `encode_png` wrote: (H, W) or (H, W, 3)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, header = len(_SIGNATURE), b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"only 8-bit gray or RGB, not interlaced: {header}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("only filter type 0 is read")
    pixels = rows[:, 1:].reshape(h, w, channels)
    return pixels[:, :, 0] if channels == 1 else pixels


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
