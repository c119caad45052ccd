"""Experiment bookkeeping: run folders, checkpoints, preemption, writers.

Counterpart of ctdd_tpu/utils/bookkeeping.py, which keeps an orbax
directory of the whole TrainState. A port checkpoint is one `.pt` file
holding {params, ema_params, step, config} (all that serving needs) and,
when a trainer wrote it, `opt_state` {count, mu, nu} and `ema_num_updates`;
`CheckpointManager` keeps the newest few as `<step>.pt` in one directory.
The run's config is JSON (`config/config.json`).
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re
import signal
import subprocess
import sys
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ctdd_tpu_torch.config.base import load_config
from ctdd_tpu_torch.utils import png


def _cpu(tree):
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    ema_params: Mapping[str, torch.Tensor], step: int,
                    config, **extra) -> str:
    """Write the checkpoint atomically (a temporary file, then a rename);
    `extra` entries (dicts of tensors, numbers) are stored beside the four
    keys every checkpoint has."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": _cpu(params),
        "ema_params": _cpu(ema_params),
        "step": int(step),
        "config": config.to_dict() if hasattr(config, "to_dict") else dict(config),
        **_cpu(extra),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> dict[str, Any]:
    """The checkpoint's dict; tensors land on `map_location`."""
    ckpt = torch.load(path, map_location=map_location, weights_only=True)
    missing = {"params", "ema_params", "step", "config"} - set(ckpt)
    if missing:
        raise KeyError(f"{path} is not a port checkpoint: missing {sorted(missing)}")
    return ckpt


def create_experiment_folder(save_location: str, experiment_name: str) -> dict:
    """Dated run folder with checkpoints/, config/ and pngs/. A second run
    started in the same second gets a `-<n>` suffix."""
    now = datetime.datetime.now()
    base = os.path.join(save_location, now.strftime("%Y-%m-%d"),
                        experiment_name + now.strftime("_%H-%M-%S"))
    folder, n = base, 1
    while os.path.exists(folder):
        folder, n = f"{base}-{n}", n + 1
    paths = {
        "root": folder,
        "checkpoints": os.path.join(folder, "checkpoints"),
        "config": os.path.join(folder, "config"),
        "pngs": os.path.join(folder, "pngs"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    save_git_hash(folder)
    return paths


def save_git_hash(save_dir: str) -> None:
    """Stamp the run folder with the current commit; skipped outside a git
    checkout."""
    try:
        h = subprocess.check_output(
            ["git", "rev-parse", "--verify", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL, timeout=30,
        ).decode()
    except (OSError, subprocess.SubprocessError):
        return
    with open(os.path.join(save_dir, "git_hash.txt"), "w") as f:
        f.write(h)


def _steps_in(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.fullmatch(r"(\d+)\.pt", f)))


class CheckpointManager:
    """Rolling `<step>.pt` checkpoints of a TrainState, newest `max_to_keep`
    kept."""

    def __init__(self, directory: str, config=None, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.config = config
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return _steps_in(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state) -> None:
        if self.latest_step() == step:
            return  # already checkpointed at this step (idempotent save)
        save_checkpoint(
            self.path(step), state.params, state.ema_params, step, self.config,
            opt_state={"count": state.opt_state.count, "mu": state.opt_state.mu,
                       "nu": state.opt_state.nu},
            ema_num_updates=state.ema_num_updates,
        )
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    @torch.no_grad()
    def restore(self, state, step: Optional[int] = None):
        """Copy checkpoint `step` (default: the newest) into `state`'s
        tensors in place, which keep their device; returns the state with
        its counters restored."""
        steps = self.all_steps()
        if step is not None and step not in steps:
            raise FileNotFoundError(
                f"checkpoint step {step} not found; available: {steps}")
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
            step = steps[-1]
        ckpt = load_checkpoint(self.path(step))
        if "opt_state" not in ckpt:
            raise KeyError(f"{self.path(step)} holds no optimizer state: "
                           "not written by the trainer")
        opt = ckpt["opt_state"]
        for mine, theirs in ((state.params, ckpt["params"]),
                             (state.ema_params, ckpt["ema_params"]),
                             (state.opt_state.mu, opt["mu"]),
                             (state.opt_state.nu, opt["nu"])):
            if set(mine) != set(theirs):
                raise KeyError(f"{self.path(step)}: parameters differ from the "
                               f"model's: {sorted(set(mine) ^ set(theirs))[:5]}")
            for k, v in mine.items():
                v.copy_(theirs[k])
        state.opt_state.count = int(opt["count"])
        state.step = int(ckpt["step"])
        state.ema_num_updates = int(ckpt["ema_num_updates"])
        return state


class PreemptionHandler:
    """Checkpoint-on-signal: SIGCONT/SIGINT/SIGTERM append to
    preemption_log.txt and raise `preempted`; the loop then calls
    `exit_if_preempted` where its state is whole, which saves a final
    checkpoint and exits 0. The handler itself saves nothing: a step
    updates params, moments and EMA in place, so a save from inside the
    signal could catch them half updated. Without a `run_dir` (a
    data-parallel rank above 0) it only raises the flag."""

    SIGNALS = (signal.SIGCONT, signal.SIGINT, signal.SIGTERM)

    def __init__(self, run_dir: Optional[str]):
        self.run_dir = run_dir
        self._save_fn = None
        self._previous = {}
        self.preempted = False

    def set_save_fn(self, fn):
        self._save_fn = fn

    def install(self):
        for sig in self.SIGNALS:
            self._previous[sig] = signal.signal(sig, self._handler)

    def uninstall(self):
        """Put back the handlers `install` replaced."""
        for sig, old in self._previous.items():
            signal.signal(sig, old)
        self._previous = {}

    def _handler(self, signum, frame):
        self.preempted = True
        if self.run_dir is None:
            return
        with open(os.path.join(self.run_dir, "preemption_log.txt"), "a") as f:
            f.write(f"{datetime.datetime.now().isoformat()} signal {signum}\n")

    def exit_if_preempted(self):
        """After a signal: save through the save function and exit 0."""
        if not self.preempted:
            return
        if self._save_fn is not None:
            self._save_fn()
        sys.exit(0)


def check_for_preempted_run(
    save_location: str, experiment_name: str, cfg, lookback_days: int = 7
) -> Optional[str]:
    """The config-equal run folder of the last `lookback_days` days whose
    checkpoints hold the highest step, or None. Runs with no checkpoint are
    skipped (a run that died before its first save is not resumable)."""
    want = json.loads(json.dumps(cfg.to_dict()))  # the JSON form on disk
    best, best_step = None, -1
    for back in range(lookback_days):
        day = (datetime.datetime.now() - datetime.timedelta(days=back)).strftime("%Y-%m-%d")
        pattern = os.path.join(save_location, day, experiment_name + "_*")
        for folder in sorted(glob.glob(pattern), reverse=True):
            cfg_path = os.path.join(folder, "config", "config.json")
            if not os.path.exists(cfg_path):
                continue
            try:
                other = load_config(cfg_path).to_dict()
            except (OSError, ValueError):
                continue
            if other != want:
                continue
            steps = _steps_in(os.path.join(folder, "checkpoints"))
            if steps and steps[-1] > best_step:
                best, best_step = folder, steps[-1]
    return best


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------


class DummyWriter:
    def add_scalar(self, *a, **k): ...

    def add_figure(self, *a, **k): ...

    def add_image(self, *a, **k): ...

    def flush(self): ...

    def close(self): ...


class NumpyWriter:
    """Accumulates scalars into `<tag>.npz` files (steps, values); writes
    figures and images as `<tag>_<step>.png`."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._scalars: dict = {}

    def add_scalar(self, tag: str, value, step: int):
        self._scalars.setdefault(tag, []).append((step, float(value)))

    def _png_path(self, tag: str, step: int) -> str:
        return os.path.join(self.directory, f"{tag.replace('/', '_')}_{step}.png")

    def add_figure(self, tag: str, fig, step: int) -> str:
        """Save a matplotlib figure."""
        path = self._png_path(tag, step)
        fig.savefig(path)
        return path

    def add_image(self, tag: str, img, step: int, dataformats: str = "HW") -> str:
        """Write a uint8 (H, W) or (H, W, 3) image (`dataformats` "HW" or
        "HWC", as tensorboard's writer names them) with the port's own PNG
        encoder."""
        if dataformats not in ("HW", "HWC"):
            raise ValueError(f"dataformats {dataformats!r}: HW or HWC")
        return png.write_png(self._png_path(tag, step), np.asarray(img))

    def flush(self):
        for tag, vals in self._scalars.items():
            arr = np.asarray(vals)
            np.savez(os.path.join(self.directory, tag.replace("/", "_") + ".npz"),
                     steps=arr[:, 0], values=arr[:, 1])

    def close(self):
        self.flush()


def setup_writer(kind: str, directory: str):
    """'numpy' | 'tensorboard' (numpy where tensorboard is not installed) |
    'none'."""
    if kind == "tensorboard":
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return NumpyWriter(directory)
        return SummaryWriter(directory, flush_secs=30)
    if kind == "numpy":
        return NumpyWriter(directory)
    if kind == "none":
        return DummyWriter()
    raise ValueError(f"unknown writer {kind!r}: numpy, tensorboard or none")
