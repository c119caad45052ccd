"""Figure loggers: noise -> one-step denoise grids for images and note
sequences, and the sample-grid figure.

Counterpart of ctdd_tpu/loggers/loggers.py: `denoisingImages` and
`ConditionalDenoisingNoteSeq`, registered in the port's `loggers` registry
under JAX's names, with JAX's tags, times and step numbers. The noising and
the denoise run on the model's device; only the small panels reach the host.
Where matplotlib can be imported a logger draws JAX's figure and hands it to
`writer.add_figure`; where it cannot (the GPU machine has none) it hands
the panels, tiled into one uint8 image, to `writer.add_image` (the numpy
writer's PNG encoder) and prints one line that says so. Each logger returns
its panels. The categorical draw x_t ~ q_{t|0}(.|x0) is a Gumbel-max draw
from a `torch.Generator` seeded by the step (JAX: `PRNGKey(step)`, split
once per t), and can take its Gumbel noise injected.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops import indexing
from ctdd_tpu_torch.utils.math import gumbel_noise, safe_log

DENOISING_TS = (0.01, 0.3, 0.5, 0.6, 0.7, 0.8, 1.0)
NOTESEQ_TS = (0.01, 0.1, 0.3, 0.7, 1.0)


def get_logger(name: str):
    return registry.loggers.get(name)


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _noise(model, x0: torch.Tensor, t: float, generator=None,
           gumbel: Optional[torch.Tensor] = None):
    """x_t ~ q_{t|0}(.|x0), int32 (B, D), and the (B,) times: the argmax of
    log q_{t|0}(x0, .) plus Gumbel noise (`gumbel`, (B, D, S), else drawn
    from `generator`)."""
    t_ones = torch.full((x0.shape[0],), t, dtype=torch.float32, device=x0.device)
    logp = safe_log(indexing.rows(model.transition(t_ones), x0))
    if gumbel is None:
        gumbel = gumbel_noise(generator, logp.shape, logp.device)
    return torch.argmax(logp + gumbel.to(logp.device), dim=-1).to(torch.int32), t_ones


@torch.inference_mode()
def _noise_and_denoise(model, params, x0: torch.Tensor, t: float, generator=None,
                       gumbel: Optional[torch.Tensor] = None):
    """x_t ~ q_{t|0}(.|x0); x̂0 = argmax p0t(.|x_t), both (B, D)."""
    x_t, t_ones = _noise(model, x0, t, generator, gumbel)
    logits = model.apply(params, x_t, t_ones)
    return x_t, torch.argmax(logits, dim=-1)


def to_pixels(states: np.ndarray, S: int) -> np.ndarray:
    """States in [0, S) as uint8 intensities in [0, 255]."""
    return np.rint(np.asarray(states, np.float64) * (255.0 / (S - 1))).astype(np.uint8)


def tile(cells) -> np.ndarray:
    """A rows x columns nested list of equal (H, W[, C]) arrays, as one."""
    return np.concatenate([np.concatenate(row, axis=1) for row in cells], axis=0)


def _image(flat: np.ndarray, shape) -> np.ndarray:
    """(C*H*W,) -> (H, W) or (H, W, C)."""
    C, H, W = shape
    img = np.asarray(flat).reshape(C, H, W).transpose(1, 2, 0)
    return img[:, :, 0] if C == 1 else img


def denoising_grid(panels: dict, shape, S: int) -> np.ndarray:
    """The uint8 image of `denoisingImages`' panels: for each image a row
    of x_t and a row of x̂0, one column per t."""
    n_img = panels["x_t"].shape[1]
    return tile([[to_pixels(_image(panels[key][j, i], shape), S)
                  for j in range(len(panels["ts"]))]
                 for i in range(n_img) for key in ("x_t", "x_hat")])


def note_panel(seq: np.ndarray, S: int) -> np.ndarray:
    """A (S, L) uint8 scatter of a sequence: 255 at (S-1-value, position)."""
    seq = np.asarray(seq)
    out = np.zeros((S, len(seq)), np.uint8)
    out[S - 1 - seq, np.arange(len(seq))] = 255
    return out


def noteseq_grid(panels: dict, S: int) -> np.ndarray:
    """The uint8 image of `ConditionalDenoisingNoteSeq`'s panels: the
    prefix then x_t on the first row, the prefix then x̂0 on the second."""
    return tile([[note_panel(np.concatenate([panels["cond"], panels[key][j]]), S)
                  for j in range(len(panels["ts"]))] for key in ("x_t", "x_hat")])


def _to_writer(writer, tag: str, step: int, plt, draw, image):
    """JAX's figure through `add_figure` where matplotlib imports, else the
    tiled panels through `add_image`."""
    if plt is not None:
        fig = draw(plt)
        writer.add_figure(tag, fig, step)
        plt.close(fig)
        return
    img = image()
    print(f"{tag} at step {step}: matplotlib is not installed; the panels go to the "
          "writer as one PNG image (add_image)", flush=True)
    writer.add_image(tag, img, step, dataformats="HW" if img.ndim == 2 else "HWC")


@registry.loggers.register(name="denoisingImages")
def denoisingImages(*, state, cfg, writer, minibatch, model, params=None, **kw):
    """3 images x 7 times: (noised, one-step denoised) with the EMA weights
    (or `params`). Returns the panels {ts, x0, x_t, x_hat}, x_t and x_hat
    (len(ts), 3, D)."""
    params = params if params is not None else state.ema_params
    step = int(state.step)
    shape = tuple(cfg.data.shape)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(step)
    x0 = torch.as_tensor(np.asarray(minibatch[:3]).reshape(3, -1), device=dev).long()
    xs, hats = [], []
    for t in DENOISING_TS:
        x_t, x_hat = _noise_and_denoise(model, params, x0, t, gen)
        xs.append(x_t.cpu().numpy())
        hats.append(x_hat.cpu().numpy())
    panels = dict(ts=DENOISING_TS, x0=x0.cpu().numpy(), x_t=np.stack(xs), x_hat=np.stack(hats))

    def draw(plt):
        fig, ax = plt.subplots(6, len(DENOISING_TS), figsize=(2 * len(DENOISING_TS), 12))
        for j in range(len(DENOISING_TS)):
            for i in range(3):
                for r, key in ((2 * i, "x_t"), (2 * i + 1, "x_hat")):
                    ax[r, j].imshow(_image(panels[key][j, i], shape))
                    ax[r, j].axis("off")
        return fig

    _to_writer(writer, "denoisingImages", step, pyplot(), draw,
               lambda: denoising_grid(panels, shape, cfg.data.S))
    return panels


@registry.loggers.register(name="ConditionalDenoisingNoteSeq")
def ConditionalDenoisingNoteSeq(*, state, cfg, writer, minibatch, model, params=None,
                                **kw):
    """Prefix-conditioned sequence denoise at 5 times: the first sequence's
    prefix kept, the rest noised to x_t and denoised in one step. Returns
    the panels {ts, cond, x_t, x_hat}, x_t and x_hat (len(ts), L - prefix)."""
    params = params if params is not None else state.ema_params
    step = int(state.step)
    cond_dim = int(cfg.loss.condition_dim)
    total_L, S = int(cfg.data.shape[0]), int(cfg.data.S)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(step)
    x = torch.as_tensor(np.asarray(minibatch[:1]).reshape(1, -1), device=dev).long()
    cond, data = x[:, :cond_dim], x[:, cond_dim:]
    xs, hats = [], []
    with torch.inference_mode():
        for t in NOTESEQ_TS:
            x_t, t_ones = _noise(model, data, t, gen)
            logits = model.apply(params, torch.cat([cond.to(torch.int32), x_t], dim=1),
                                 t_ones)[:, cond_dim:, :]
            xs.append(x_t[0].cpu().numpy())
            hats.append(torch.argmax(logits, dim=-1)[0].cpu().numpy())
    panels = dict(ts=NOTESEQ_TS, cond=cond[0].cpu().numpy(), x_t=np.stack(xs),
                  x_hat=np.stack(hats))

    def draw(plt):
        fig, ax = plt.subplots(2, len(NOTESEQ_TS), figsize=(2 * len(NOTESEQ_TS), 4))
        pos = np.arange(total_L)
        for j in range(len(NOTESEQ_TS)):
            for r, key in ((0, "x_t"), (1, "x_hat")):
                ax[r, j].scatter(pos, np.concatenate([panels["cond"], panels[key][j]]), s=0.1)
                ax[r, j].set_ylim(0, S)
                ax[r, j].axis("off")
        return fig

    _to_writer(writer, "ConditionalDenoisingNoteSeq", step, pyplot(), draw,
               lambda: noteseq_grid(panels, S))
    return panels


def sample_grid(samples: np.ndarray, shape, S: int, nrow: int = 4) -> np.ndarray:
    """The uint8 image of a sample grid: `nrow` rows of images, as many
    columns as needed, empty cells black."""
    C, H, W = shape
    n = len(samples)
    ncol = int(np.ceil(n / nrow))
    blank = np.zeros((H, W) if C == 1 else (H, W, C), np.uint8)
    return tile([[to_pixels(_image(samples[r * ncol + c], shape), S)
                  if r * ncol + c < n else blank for c in range(ncol)] for r in range(nrow)])


def sample_grid_figure(samples: np.ndarray, shape, nrow: int = 4):
    """A matplotlib figure of a sample grid (matplotlib imported here)."""
    plt = pyplot()
    if plt is None:
        raise ImportError("sample_grid_figure needs matplotlib; sample_grid draws "
                          "the same grid as a uint8 image")
    C, H, W = shape
    n = len(samples)
    ncol = int(np.ceil(n / nrow))
    fig, axes = plt.subplots(nrow, ncol, figsize=(ncol, nrow))
    axes = np.atleast_2d(axes)
    for i in range(nrow * ncol):
        ax = axes[i // ncol, i % ncol]
        ax.axis("off")
        if i < n:
            ax.imshow(_image(samples[i], shape), cmap="gray")
    fig.tight_layout()
    return fig
