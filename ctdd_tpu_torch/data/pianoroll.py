"""Pianoroll sequences: the seeded stand-in and the conditional metrics.

Counterpart of ctdd_tpu/data/pianoroll.py (numpy, so the stand-in is the JAX
package's array for the same seed). The Lakh pianoroll is an (N, 256) int
array over S=129 (MIDI pitches 0..127 and 128 = rest); it is not in the
repository, so `generate_standin` makes a stand-in with real prefix ->
suffix structure: each sequence keeps one of 12 major keys and a register,
and a scale-degree walk with rests and sustained notes writes the notes.

- `infer_key(prefix)` (numpy) and `infer_key_torch` (the CondNLL aux
  labels) give the key that most prefix notes fit;
- `scale_consistency(seqs, cond_dim)`: the mean share of suffix notes in
  the key inferred from the prefix alone (~1.0 for ground truth, ~0.55-0.65
  for a suffix from another key).

Numbers on the stand-in are not comparable to results on the real Lakh
data; `data/pianoroll/train.npy` takes its place where it exists.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

REST = 128
_MAJOR = np.array([0, 2, 4, 5, 7, 9, 11])


def _scale_pitches(key: int, lo: int = 24, hi: int = 104) -> np.ndarray:
    """All MIDI pitches of the major scale `key` within [lo, hi]."""
    pcs = (_MAJOR + key) % 12
    pitches = np.arange(lo, hi + 1)
    return pitches[np.isin(pitches % 12, pcs)]


def generate_standin(
    n: int, length: int = 256, seed: int = 0,
    beat: int = 4, rest_prob: float = 0.10, leap_prob: float = 0.12,
) -> np.ndarray:
    """(n, length) int32 stand-in pianoroll, vocabulary 0..128.

    Per sequence: key ~ U(12), register center ~ U(48, 72); a scale-degree
    walk emits one token per `beat` steps (sustained notes repeat their
    token), with rests at `rest_prob` and leaps of 4-7 scale degrees at
    `leap_prob` (otherwise steps of 0-2 degrees).
    """
    rng = np.random.default_rng(seed)
    n_beats = (length + beat - 1) // beat
    out = np.empty((n, length), np.int32)
    for i in range(n):
        key = int(rng.integers(12))
        pitches = _scale_pitches(key)
        center = int(rng.integers(48, 73))
        deg = int(np.argmin(np.abs(pitches - center)))
        toks = np.empty(n_beats, np.int32)
        for b in range(n_beats):
            if rng.random() < rest_prob:
                toks[b] = REST
                continue
            if rng.random() < leap_prob:
                move = int(rng.integers(4, 8))
            else:
                move = int(rng.integers(0, 3))
            sign = -1 if rng.random() < 0.5 else 1
            # soft pull back toward the register center
            if abs(pitches[deg] - center) > 12:
                sign = 1 if pitches[deg] < center else -1
            deg = int(np.clip(deg + sign * move, 0, len(pitches) - 1))
            toks[b] = pitches[deg]
        out[i] = np.repeat(toks, beat)[:length]
    return out


def scale_membership() -> np.ndarray:
    """(12, 12) bool: membership[key, pc] = pitch-class pc is in major key."""
    member = np.zeros((12, 12), bool)
    for key in range(12):
        member[key, (_MAJOR + key) % 12] = True
    return member


def infer_key_torch(prefix: torch.Tensor) -> torch.Tensor:
    """The torch twin of `infer_key` for the aux loss's labels, on the
    prefix's device: (B, L_p) int -> (B,) int64. Ties break toward the
    lowest key index, as numpy's argmax does."""
    member = torch.as_tensor(scale_membership(), dtype=torch.float32,
                             device=prefix.device)  # (12, 12)
    p = prefix.long()
    valid = p < REST  # rests don't vote
    pc = torch.where(valid, p % 12, torch.zeros_like(p))
    onehot_pc = F.one_hot(pc, 12).float() * valid[..., None]  # (B, L, 12)
    scores = torch.einsum("blp,kp->bk", onehot_pc, member)
    return scores.argmax(dim=1)  # the first of equal maxima


def infer_key(prefix: np.ndarray) -> np.ndarray:
    """Most-compatible major key per row from prefix notes.

    prefix: (N, L_p) ints. Returns (N,) key indices 0..11 maximizing the
    count of non-rest prefix pitch classes inside that key's scale.
    """
    prefix = np.asarray(prefix)
    notes = np.where(prefix >= REST, -1, prefix % 12)  # -1 = rest/invalid
    scores = np.zeros((prefix.shape[0], 12), np.int32)
    for key in range(12):
        pcs = (_MAJOR + key) % 12
        scores[:, key] = (np.isin(notes, pcs) & (notes >= 0)).sum(axis=1)
    return np.argmax(scores, axis=1)


def scale_consistency(seqs: np.ndarray, cond_dim: int) -> float:
    """Mean fraction of suffix notes inside the key inferred from the prefix.

    The direct conditional-generation metric on the stand-in: ground truth
    scores ~1.0 (key persists across the whole sequence); a model that
    ignores its conditioner scores the cross-key collision rate (~0.55-0.65).
    Rows whose suffix is all rests are skipped.
    """
    seqs = np.asarray(seqs)
    keys = infer_key(seqs[:, :cond_dim])
    suffix = seqs[:, cond_dim:]
    notes = np.where(suffix >= REST, -1, suffix % 12)
    in_scale = np.zeros(suffix.shape, bool)
    for key in range(12):
        rows = keys == key
        if rows.any():
            pcs = (_MAJOR + key) % 12
            in_scale[rows] = np.isin(notes[rows], pcs)
    valid = notes >= 0
    counts = valid.sum(axis=1)
    ok = counts > 0
    if not ok.any():
        return float("nan")
    frac = (in_scale & valid).sum(axis=1)[ok] / counts[ok]
    return float(frac.mean())
