"""The training loop, on one device or data-parallel over several ranks.

Counterpart of ctdd_tpu/training/loop.py: train step (over a dataset on
the device, or host batches when the dataset is larger than
`training.device_data_bytes`) -> periodic checkpoint, loss log
and sample grid with the EMA weights -> a final checkpoint, with a
checkpoint between steps after SIGTERM/SIGINT/SIGCONT. With
`data.stream_fresh` a dataset that can `regenerate` (the maze and sudoku
pools) swaps in a fresh pool on the device every
`data.stream_refresh_period` epochs, generated on a background thread while
the device trains when `data.stream_async` is on (the default for a period
above 1); pools are keyed by the absolute epoch, so a resume replays the
stream. On a CUDA device cuDNN and the attention backward run
deterministic for the whole run.
A label-conditional model (DiT) over a labelled dataset trains with the
batch's labels (only NLLOriginal conditions on them) and draws its grid
one class per row. Sample grids are saved as `samples_<step>.npy`, and for
image shapes also as the PNG `samples_<step>.png` (the port's own encoder,
no matplotlib); at the end the logged losses are plotted to
`loss_curve.png` where matplotlib can be imported. With `loss.name=d3pm`
the loss is the D3PM baseline's (`d3pm/diffusion.py`); a D3PM model without
a CTMC process draws no in-loop grid (it samples through the eval CLI), while
`mnist_d3pm`'s UNet, which has one, draws its TauL grid as JAX's loop does.
With `data.use_augm` the batch is rotated or flipped on the device inside the
step (`data/augment.py`).

The steps are parallel/dp.py's at any world size; on the one-rank mesh
without a process group their reduction is the identity, and they are the
single-device steps of training/train_step.py. Given a mesh of more than
one rank (parallel/mesh.py), every rank trains a full copy with the
mean-reduced steps: over its own copy of a dataset on the device
(`batch_size // world` rows a rank), or over its shard of each host batch
(every rank draws the same global batches). Rank 0 alone creates the run
folder and writes the config, checkpoints, the loss log, the grids and the
loss curve; every rank restores the same checkpoint on a resume, and a
signal on any rank stops all of them at the same step.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ctdd_tpu_torch.config.base import save_config
from ctdd_tpu_torch.d3pm.diffusion import D3PMLoss, make_diffusion
from ctdd_tpu_torch.data.augment import make_augment_fn
from ctdd_tpu_torch.data.loaders import get_dataset, iterate_batches
from ctdd_tpu_torch.loggers.loggers import pyplot, sample_grid
from ctdd_tpu_torch.losses.losses import get_loss
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.parallel.dp import make_device_data_train_step, make_dp_train_step
from ctdd_tpu_torch.parallel.mesh import make_mesh, shard_batch
from ctdd_tpu_torch.sampling.samplers import get_sampler
from ctdd_tpu_torch.training.optimizers import get_optimizer
from ctdd_tpu_torch.training.state import create_train_state
from ctdd_tpu_torch.utils import bookkeeping, png
from ctdd_tpu_torch.utils.device import deterministic_training
from ctdd_tpu_torch.utils.trace import DATA_POOL_WAIT, span


def _refuse_unported(model):
    if not hasattr(model.net, "init_weights"):
        raise NotImplementedError(
            f"training with {type(model.net).__name__} (no init_weights) is ported in a "
            "later slice")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PoolStream:
    """The `data.stream_fresh` pools of a dataset that can `regenerate`.

    The pool trained on at step `it` is the one of epoch
    (it // steps_per_epoch) // period * period, generated on the host and
    moved to `device` whole at the swap. With `use_async` the next pool is
    generated on a background thread (ctypes releases the GIL inside the C++
    generators) and `collect` waits for it. `swaps` records each swap as
    (step, epoch, seconds waited for the generator, digest of the pool)."""

    def __init__(self, dataset, steps_per_epoch: int, period: int, device,
                 use_async: bool):
        self.dataset = dataset
        self.steps_per_epoch = steps_per_epoch
        self.period = period
        self.steps_per_pool = steps_per_epoch * period
        self.device = device
        self.use_async = use_async
        self.swaps = []
        self._thread = None
        self._box = {}

    def epoch(self, it: int) -> int:
        return (it // self.steps_per_epoch) // self.period * self.period

    def _host_pool(self, it: int) -> np.ndarray:
        pool = self.dataset.regenerate(self.epoch(it))
        return pool.reshape(len(self.dataset), -1).astype(np.int32)

    def _to_device(self, it: int, flat: np.ndarray, waited: float) -> torch.Tensor:
        digest = hashlib.sha256(flat.tobytes()).hexdigest()[:16]
        self.swaps.append((it, self.epoch(it), waited, digest))
        print(f"pool of epoch {self.epoch(it)} from step {it}: waited {waited:.3f} s "
              f"for the generator, sha256 {digest}", flush=True)
        return torch.from_numpy(flat).to(self.device)

    def build(self, it: int) -> torch.Tensor:
        """The pool of step `it`, generated now."""
        t0 = time.perf_counter()
        with span(DATA_POOL_WAIT):
            flat = self._host_pool(it)
        return self._to_device(it, flat, time.perf_counter() - t0)

    def prefetch(self, it: int):
        """Start generating the pool of step `it` on a background thread."""

        def run():
            try:
                self._box["flat"] = self._host_pool(it)
            except Exception as e:  # re-raised by collect()
                self._box["error"] = e

        self._box = {}
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def collect(self, it: int) -> torch.Tensor:
        """The pool `prefetch(it)` generates, waiting for its thread."""
        t0 = time.perf_counter()
        with span(DATA_POOL_WAIT):
            self.join()
        waited = time.perf_counter() - t0
        if "error" in self._box:
            raise self._box["error"]
        return self._to_device(it, self._box.pop("flat"), waited)

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _save_sample_grid(cfg, model, state, sampler, out_dir: str, step: int,
                      n_samples: int = 16, dataset=None, writer=None) -> Optional[str]:
    """Sample with the EMA weights (seeded by the step); save the states,
    and for an image shape (C, H, W) their grid as `samples_<step>.png`,
    also handed to `writer.add_image`. A label-conditional model samples
    one class per row (`data.num_classes`, 10 by default;
    `sampler.cfg_scale`, 0 by default): trained with a real
    or the null label embedding on every forward, it never sees a forward
    without one. A prefix-conditional sampler takes the first `n_samples`
    training prefixes, and is skipped where the dataset holds fewer."""
    gen = torch.Generator(device=model.device).manual_seed(step)
    if getattr(sampler, "condition_dim", None):
        if dataset is None or len(dataset) < n_samples:
            return None
        prefixes = np.asarray(dataset.data[:n_samples]).reshape(n_samples, -1)
        samples = sampler.sample(model, state.ema_params, gen, N=n_samples,
                                 conditioner=prefixes[:, :sampler.condition_dim])
    else:
        kwargs = {}
        if model.has_label:
            n_classes = int(cfg.data.get("num_classes", 10))
            kwargs = dict(label=np.arange(n_samples) % n_classes,
                          cfg_scale=float(cfg.sampler.get("cfg_scale", 0.0)))
        samples, _ = sampler.sample(model, state.ema_params, gen, N=n_samples, **kwargs)
    path = os.path.join(out_dir, f"samples_{step}.npy")
    np.save(path, samples)
    shape = cfg.data.get("shape", None)
    if shape is not None and len(shape) == 3:
        grid = sample_grid(samples, shape, int(cfg.data.S))
        png.write_png(os.path.join(out_dir, f"samples_{step}.png"), grid)
        if writer is not None:
            writer.add_image("samples", grid, step,
                             dataformats="HW" if grid.ndim == 2 else "HWC")
    return path


def _save_loss_curve(losses, log_every: int, n_start: int, root: str) -> Optional[str]:
    """`loss_curve.png` of the logged losses, where matplotlib imports;
    else one line says none was drawn (`loss.npz` of the numpy writer holds
    the same losses)."""
    plt = pyplot()
    if plt is None:
        print("loss curve: matplotlib is not installed; no loss_curve.png (the logged "
              "losses are in the writer's loss.npz)", flush=True)
        return None
    fig, ax = plt.subplots()
    ax.plot(np.arange(len(losses)) * log_every + n_start, losses)
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    path = os.path.join(root, "loss_curve.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def train(
    cfg,
    *,
    n_iters: Optional[int] = None,
    seed: int = 0,
    resume_from: Optional[str] = None,
    writer_kind: str = "numpy",
    mesh=None,
    log_every: int = 100,
    profile_steps: Optional[tuple] = None,
    device=None,
):
    """Run training on `device` (the GPU unless the caller passes another),
    or on each rank of `mesh` at its device (default: `make_mesh`, which
    is one rank unless a process group is initialized); returns (state,
    info). `info["steps_per_sec"]` is the steady-state rate:
    the first step, sample grids and checkpoint saves are left out.
    `info["losses"]` holds the logged losses, `info["step_losses"]` every
    step's (the 1e9 sentinel where a step was skipped), `info["pool_swaps"]`
    the fresh-pool swaps (`PoolStream.swaps`). On a CUDA device cuDNN and
    the attention backward run deterministic (`deterministic_training`)
    until it returns."""
    mesh = mesh if mesh is not None else make_mesh(device=device)
    with deterministic_training(mesh.device):
        return _train(cfg, n_iters=n_iters, seed=seed, resume_from=resume_from,
                      writer_kind=writer_kind, log_every=log_every,
                      profile_steps=profile_steps, mesh=mesh)


def _train(cfg, *, n_iters, seed, resume_from, writer_kind, log_every,
           profile_steps, mesh):
    n_iters = n_iters if n_iters is not None else cfg.training.n_iters
    device = mesh.device
    lead = mesh.rank == 0

    # PyTorch's default init draws from the global generator: leave the
    # caller's as it was; the weights are then drawn from `seed` as the JAX
    # package initializes them
    with torch.random.fork_rng(devices=[]):
        model = create_model(cfg, device=device)
    _refuse_unported(model)
    model.net.init_weights(torch.Generator().manual_seed(seed))

    paths = None
    if lead:
        paths = bookkeeping.create_experiment_folder(cfg.save_location, cfg.experiment_name)
        save_config(cfg, os.path.join(paths["config"], "config.json"))
    paths = mesh.broadcast_object(paths)
    writer = bookkeeping.setup_writer(writer_kind if lead else "none", paths["root"])
    ckpt = bookkeeping.CheckpointManager(paths["checkpoints"], cfg) if lead else None

    if cfg.loss.name == "d3pm":
        loss = D3PMLoss(cfg, make_diffusion(cfg.model, device=device))
    else:
        loss = get_loss(cfg)
    tx = get_optimizer(cfg)
    dataset = get_dataset(cfg)
    state = create_train_state(dict(model.net.named_parameters()), tx)
    if resume_from is not None:
        state = bookkeeping.CheckpointManager(resume_from).restore(state)

    device_data_cap = int(cfg.training.get("device_data_bytes", 512 * 2**20))
    device_data = (bool(cfg.training.get("device_data", True))
                   and dataset.data.nbytes <= device_data_cap)
    ema_decay = float(cfg.model.get("ema_decay", 0.0))
    # a fresh rotation or flip per item per step, on the device
    augment_fn = make_augment_fn(cfg)
    # stream_fresh: a fresh pool every `stream_refresh_period` epochs, so a
    # long run sees the reference's fresh-data distribution (its maze and
    # sudoku datasets generate a board per item) instead of cycling one pool
    # the label-conditional path: only a label-capable network over a
    # labelled dataset takes the batch's labels
    has_label = model.has_label and dataset.labels is not None
    stream = None
    if (device_data and bool(cfg.data.get("stream_fresh", False))
            and hasattr(dataset, "regenerate") and not has_label):
        period = max(1, int(cfg.data.get("stream_refresh_period", 1)))
        stream = PoolStream(dataset, max(1, len(dataset) // int(cfg.data.batch_size)),
                            period, device,
                            bool(cfg.data.get("stream_async", period > 1)))
    if device_data:
        data = torch.from_numpy(
            dataset.data.reshape(len(dataset), -1).astype(np.int32)).to(device)
        if has_label:
            data = (data, torch.from_numpy(np.asarray(dataset.labels, np.int64)).to(device))
        step_fn = make_device_data_train_step(
            model, loss, tx, mesh, cfg.data.batch_size, ema_decay=ema_decay,
            has_label=has_label, augment_fn=augment_fn)
    else:
        batches = iterate_batches(dataset, cfg.data.batch_size,
                                  shuffle=cfg.data.get("shuffle", True), seed=seed)
        # JAX spends the stream's first batch on model.init and trains from
        # the second: skip it, so both packages train on the same batches
        next(batches)
        step_fn = make_dp_train_step(model, loss, tx, mesh, ema_decay=ema_decay,
                                     has_label=has_label, augment_fn=augment_fn)

    checkpoint_freq = cfg.saving.get("checkpoint_freq", 10000)
    sample_freq = cfg.sampler.get("sample_freq", 0)
    # the CTMC samplers need a process: a D3PM model without one samples
    # ancestrally through the eval CLI
    has_process = model.process is not None
    sampler = (get_sampler(cfg)
               if lead and sample_freq and sample_freq <= n_iters and has_process else None)
    if lead and sample_freq and not has_process:
        print("in-loop sample grids disabled: model has no CTMC process "
              "(d3pm family) — use eval.py for sampling", flush=True)

    # a rank above 0 may not see rank 0's run folder (hosts without a shared
    # filesystem): it only raises the flag
    preempt = bookkeeping.PreemptionHandler(paths["root"] if lead else None)
    if lead:
        preempt.set_save_fn(lambda: ckpt.save(state.step, state))
    preempt.install()
    profile_steps = profile_steps if lead else None
    losses, step_losses = [], []
    n_start = state.step
    t_first = None  # end of the first step
    t_aside = 0.0  # seconds in sample grids and checkpoint saves
    prof = None
    if stream is not None and n_start > 0:
        # a resume rebuilds the pool of the epoch it restarts in (the
        # constructor's pool is epoch 0's)
        data = stream.build(n_start)
    if stream is not None and stream.use_async:
        boundary = (n_start // stream.steps_per_pool + 1) * stream.steps_per_pool
        if boundary < n_iters:
            stream.prefetch(boundary)
    try:
        for it in range(n_start, n_iters):
            # every rank stops at the same step
            preempt.preempted = mesh.any(preempt.preempted)
            preempt.exit_if_preempted()  # between steps, where `state` is whole
            if stream is not None and it > n_start and it % stream.steps_per_pool == 0:
                if stream.use_async:
                    data = stream.collect(it)
                    if it + stream.steps_per_pool < n_iters:
                        stream.prefetch(it + stream.steps_per_pool)
                else:
                    data = stream.build(it)
            if profile_steps and it == profile_steps[0]:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            if device_data:
                state, lv = step_fn(state, data, seed)
            else:
                batch, label = next(batches)
                batch = shard_batch(batch, mesh)
                if has_label:
                    label = shard_batch(np.asarray(label, np.int64), mesh)
                state, lv = step_fn(state, batch, seed, label if has_label else None)
            step_losses.append(lv)
            if prof is not None and it == profile_steps[1]:
                _sync(device)
                prof.stop()
                os.makedirs(os.path.join(paths["root"], "profile"), exist_ok=True)
                prof.export_chrome_trace(os.path.join(paths["root"], "profile", "trace.json"))
                prof = None
            if t_first is None:
                t_first = time.perf_counter()
            t0 = time.perf_counter()
            if (it + 1) % log_every == 0:
                losses.append(lv)
                writer.add_scalar("loss", lv, it + 1)
                rate = (it - n_start) / max(t0 - t_first - t_aside, 1e-9)
                if lead:
                    print(f"iter {it + 1}/{n_iters} loss {lv:.5f} ({rate:.1f} steps/s)",
                          flush=True)
            if ckpt is not None and (it + 1) % checkpoint_freq == 0:
                ckpt.save(it + 1, state)
                # the loss history is durable at every checkpoint
                writer.flush()
            if sampler is not None and (it + 1) % sample_freq == 0:
                _save_sample_grid(cfg, model, state, sampler, paths["pngs"], it + 1,
                                  dataset=dataset, writer=writer)
            t_aside += time.perf_counter() - t0
        _sync(device)
        elapsed = (time.perf_counter() - t_first - t_aside) if t_first else 0.0
        if ckpt is not None:
            ckpt.save(n_iters, state)
            if losses:
                _save_loss_curve(losses, log_every, n_start, paths["root"])
        preempt.exit_if_preempted()
    finally:
        if prof is not None:  # the window's end lies past the last step
            prof.stop()
        if stream is not None:  # a run stopped early leaves no thread behind
            stream.join()
        preempt.uninstall()
        writer.flush()
    return state, {
        "paths": paths,
        "losses": losses,
        "step_losses": step_losses,
        "pool_swaps": [] if stream is None else stream.swaps,
        "steps_per_sec": max(n_iters - n_start - 1, 1) / max(elapsed, 1e-9),
        "model": model,
    }
