"""The port's data parallelism (ctdd_tpu_torch/parallel) on the CPU over gloo,
at the tiny flagship geometry.

Ranks are spawned processes (2, and 4 once) in one gloo group. Each DP
update is held against the update one process computes from the mean of the
per-shard losses and gradients, drawn with the same rank-keyed generators:
bit for bit at 2 ranks (the mean of two is exact in any order), within 1e-6
of the largest |value| at 4 (gloo may add four shards in another order).
The JAX DP step (`ctdd_tpu/parallel/dp.py`) folds its keys inside the
compiled step and cannot take injected randomness, so the chain to JAX runs
through the single-device step: a one-rank DP step is held bit-equal to it
here, and the existing train-step tests (`test_torch_train_step.py`,
`test_torch_training_loop.py`) hold that step against JAX. `shard_batch` is
held against JAX's on the 8-device virtual mesh of `tests/conftest.py`.
"""

import dataclasses
import glob
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctdd_tpu_torch.config.presets import apply_overrides
from ctdd_tpu_torch.losses.losses import get_loss
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.parallel.dp import (
    make_device_data_train_step, make_dp_sampler, make_dp_train_step, rank_generator,
)
from ctdd_tpu_torch.parallel.dryrun import flagship_cfg, join_group, spawn
from ctdd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from ctdd_tpu_torch.sampling.samplers import get_sampler
from ctdd_tpu_torch.training.loop import train
from ctdd_tpu_torch.training.optimizers import get_optimizer
from ctdd_tpu_torch.training.state import create_train_state
from ctdd_tpu_torch.training.train_step import (
    apply_update, make_loss_fn, make_train_step, step_generator, value_and_grad,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEED = 3  # the train steps' seed
SAMPLE_SEED = 5
ROWS = 2  # rows of a rank's shard
DATA_BATCH = 4  # rows a rank draws from the dataset on its device, times the world


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread, as `test_torch_unet.one_torch_thread` (not imported
    from there: that module imports JAX, and the spawned ranks import this
    one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(tmp_dir: str):
    cfg = flagship_cfg(tiny=True)
    path = os.path.join(tmp_dir, "mnist.npz")
    if not os.path.exists(path):
        rng = np.random.default_rng(0)
        np.savez(path, x_train=rng.integers(0, 8, (32, 8, 8)).astype(np.uint8),
                 y_train=np.zeros(32, np.int64))
    return apply_overrides(cfg, {"data.location": path, "data.batch_size": 4,
                                 "sampler.sample_freq": 0, "sampler.num_steps": 3,
                                 "save_location": os.path.join(tmp_dir, "runs")})


def fresh(cfg):
    """The tiny flagship from seed 0: (model, state, tx, loss)."""
    model = create_model(cfg, device=CPU)
    model.net.init_weights(torch.Generator().manual_seed(0))
    tx = get_optimizer(cfg)
    return model, create_train_state(dict(model.net.named_parameters()), tx), tx, get_loss(cfg)


def global_batch(cfg, world: int) -> np.ndarray:
    return (np.random.RandomState(1).randint(0, cfg.data.S, (ROWS * world, cfg.model.concat_dim))
            .astype(np.int32))


def dataset_on_device(cfg) -> torch.Tensor:
    return torch.from_numpy(np.load(cfg.data.location)["x_train"].reshape(32, -1).astype(np.int32))


def snapshot(state) -> dict:
    return {"step": state.step, "params": state.params, "ema": state.ema_params,
            "mu": state.opt_state.mu, "nu": state.opt_state.nu}


class RowsSeen:
    """A loss that records the rows of every batch it is given."""

    def __init__(self, loss):
        self.loss, self.rows = loss, []

    def calc_loss(self, model, params, generator, minibatch, **kw):
        self.rows.append(int(minibatch.shape[0]))
        return self.loss.calc_loss(model, params, generator, minibatch, **kw)


def _rank(rank, world, port, tmp_dir, with_train):
    """One rank: the DP host-batch step, the device-data step, the DP
    sampler and, with `with_train`, train() and its resume; results to
    `tmp_dir/rank<r>.pt`."""
    import torch.distributed as dist

    mesh = join_group(rank, world, port, "cpu")
    try:
        cfg = tiny_cfg(tmp_dir)
        out = {"mesh": (mesh.world, mesh.rank, mesh.backend)}
        model, state, tx, loss = fresh(cfg)
        step = make_dp_train_step(model, loss, tx, mesh, ema_decay=0.9999)
        state, out["loss"] = step(state, shard_batch(global_batch(cfg, world), mesh), SEED)
        out["dp"] = snapshot(state)

        model, state, tx, loss = fresh(cfg)
        seen = RowsSeen(loss)
        step = make_device_data_train_step(model, seen, tx, mesh, DATA_BATCH * world,
                                           ema_decay=0.9999)
        state, out["data_loss"] = step(state, dataset_on_device(cfg), SEED)
        out["data_rows"] = seen.rows
        out["data_params"] = state.params

        sample = make_dp_sampler(get_sampler(cfg), mesh)
        out["sample_weights"] = state.ema_params
        out["samples"] = sample(model, state.ema_params, SAMPLE_SEED, 2 * world)
        try:
            sample(model, state.ema_params, SAMPLE_SEED, 2 * world + 1)
        except ValueError as e:
            out["uneven_raises"] = str(e)

        if with_train:
            cfg.saving.checkpoint_freq = 2
            first, info = train(cfg, n_iters=4, seed=0, mesh=mesh, log_every=2)
            out["train"] = dict(paths=info["paths"], losses=info["losses"],
                                params=first.params)
            resumed, info = train(cfg, n_iters=6, seed=0, mesh=mesh, log_every=2,
                                  resume_from=out["train"]["paths"]["checkpoints"])
            out["resumed"] = dict(paths=info["paths"], step=resumed.step,
                                  params=resumed.params, losses=info["losses"])
            cfg.training.device_data_bytes = 0  # host batches, sharded
            host, _ = train(cfg, n_iters=2, seed=0, mesh=mesh, log_every=1)
            out["host_batches"] = host.params
        torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))
        if with_train:
            signalled_run(cfg, mesh, "signalled", on_rank=0)
            signalled_run(cfg, FolderElsewhere(mesh.world, mesh.rank, mesh.device, mesh.backend,
                                               os.path.join(tmp_dir, "not_on_this_host")),
                          "signalled_elsewhere", on_rank=1)
    finally:
        dist.destroy_process_group()


class SignalsItself:
    """A loss that sends SIGTERM to its own process, on rank `rank`, while
    the step of index `at` runs."""

    def __init__(self, loss, rank: int, at: int):
        self.loss, self.rank, self.at = loss, rank, at

    def calc_loss(self, model, params, generator, minibatch, n_iter=0, **kw):
        import torch.distributed as dist

        if dist.get_rank() == self.rank and n_iter == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.loss.calc_loss(model, params, generator, minibatch, n_iter=n_iter, **kw)


@dataclasses.dataclass(frozen=True)
class FolderElsewhere(Mesh):
    """A mesh on which the ranks above 0 receive rank 0's run-folder paths
    moved under `absent`, a folder that does not exist: ranks on hosts that
    share no filesystem with rank 0."""

    absent: str = ""

    def broadcast_object(self, obj):
        obj = super().broadcast_object(obj)
        if self.rank and isinstance(obj, dict):
            obj = {k: os.path.join(self.absent, k) for k in obj}
        return obj


def signalled_run(cfg, mesh, folder: str, on_rank: int):
    """train() for 10 steps, runs under `folder`, in which rank `on_rank`
    receives SIGTERM during step 2; both ranks should stop at the next step
    boundary, rank 0 saving, and leave train() through the exit of a
    preempted run."""
    from ctdd_tpu_torch.training import loop

    cfg.training.device_data_bytes = 512 * 2**20
    cfg.saving.checkpoint_freq = 1000
    cfg.save_location = os.path.join(os.path.dirname(cfg.save_location), folder)
    made = loop.get_loss
    loop.get_loss = lambda c: SignalsItself(made(c), rank=on_rank, at=2)
    try:
        train(cfg, n_iters=10, seed=0, mesh=mesh, log_every=1)
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    else:
        raise AssertionError(f"rank {mesh.rank} ran all 10 steps of the signalled run")
    finally:
        loop.get_loss = made


def run_ranks(tmp_dir, world: int, with_train: bool) -> list:
    spawn(_rank, world, str(tmp_dir), with_train)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp2")
    return tmp, run_ranks(tmp, 2, with_train=True)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp4")
    return tmp, run_ranks(tmp, 4, with_train=False)


def mean_update(cfg, world: int):
    """The update of one process from the mean of the per-shard losses and
    gradients, each shard drawn as its rank draws (`step_generator` keyed by
    the rank); returns (state, loss)."""
    model, state, tx, loss = fresh(cfg)
    loss_fn = make_loss_fn(model, loss)
    batch = torch.from_numpy(global_batch(cfg, world))
    values, grads = [], []
    for r in range(world):
        gen = step_generator(SEED, 0, CPU, rank=r)
        shard = batch[r * ROWS:(r + 1) * ROWS]
        v, g = value_and_grad(lambda p: loss_fn(p, shard, gen, None, 0), state.params)
        values.append(v)
        grads.append(g)
    mean = {k: sum(g[k] for g in grads) / world for k in grads[0]}
    return apply_update(state, sum(values) / world, mean, tx, 0.9999)


def assert_same(a: dict, b: dict, tol: float = 0.0):
    assert set(a) == set(b)
    for k in a:
        if tol:
            scale = float(b[k].detach().abs().max())
            assert float((a[k] - b[k]).detach().abs().max()) <= tol * max(scale, 1e-30), k
        else:
            assert torch.equal(a[k], b[k]), k


def test_dp_step_is_the_mean_update_at_two_ranks(two_ranks):
    tmp, ranks = two_ranks
    assert [r["mesh"] for r in ranks] == [(2, 0, "gloo"), (2, 1, "gloo")]
    want_state, want_loss = mean_update(tiny_cfg(str(tmp)), 2)
    for r in ranks:
        assert r["loss"] == want_loss and r["dp"]["step"] == 1
        for key, want in (("params", want_state.params), ("ema", want_state.ema_params),
                          ("mu", want_state.opt_state.mu), ("nu", want_state.opt_state.nu)):
            assert_same(r["dp"][key], want)


def test_dp_step_is_the_mean_update_at_four_ranks(four_ranks):
    tmp, ranks = four_ranks
    want_state, want_loss = mean_update(tiny_cfg(str(tmp)), 4)
    for r in ranks:
        assert_same(r["dp"]["params"], ranks[0]["dp"]["params"])  # bit-identical
        assert r["loss"] == pytest.approx(want_loss, rel=1e-6)
        assert_same(r["dp"]["params"], want_state.params, tol=1e-6)


def test_device_data_step_draws_its_share_of_the_batch(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert r["data_rows"] == [DATA_BATCH]
        assert_same(r["data_params"], ranks[0]["data_params"])
    assert ranks[0]["data_loss"] == ranks[1]["data_loss"]


def test_device_data_step_refuses_a_batch_below_the_mesh():
    cfg = flagship_cfg(tiny=True)
    model, _, tx, loss = fresh(cfg)
    with pytest.raises(ValueError, match="cover the mesh"):
        make_device_data_train_step(model, loss, tx, Mesh(4, 0, CPU, "gloo"), 3)


def test_dp_sampler_gathers_the_ranks_in_order(two_ranks):
    """Shape (N, D), states in [0, S), the same on every rank, and rank r's
    rows are the sampler's loop from `rank_generator(seed, r)`."""
    tmp, ranks = two_ranks
    cfg = tiny_cfg(str(tmp))
    model = fresh(cfg)[0]
    out = ranks[0]["samples"]
    assert out.shape == (4, cfg.model.concat_dim)
    assert out.min() >= 0 and out.max() < cfg.data.S
    np.testing.assert_array_equal(ranks[1]["samples"], out)
    sampler = get_sampler(cfg)
    for r in range(2):
        with torch.inference_mode():
            x, _ = sampler._sample_loop(model, ranks[0]["sample_weights"],
                                        rank_generator(SAMPLE_SEED, r, CPU), 2)
        np.testing.assert_array_equal(out[2 * r:2 * r + 2], x.numpy())
    assert all("must divide over 2 ranks" in r["uneven_raises"] for r in ranks)


def test_train_on_two_ranks(two_ranks):
    """train(mesh=...): one run folder, rank 0's checkpoints alone, the same
    weights on both ranks; a resume from them restores on both ranks; the
    host-batch branch (shard_batch) keeps the ranks equal too."""
    tmp, ranks = two_ranks
    first, resumed = ranks[0]["train"], ranks[0]["resumed"]
    assert [r["train"]["paths"] for r in ranks] == [first["paths"]] * 2
    runs = sorted(glob.glob(os.path.join(str(tmp), "runs", "*", "*")))
    assert len(runs) == 3  # train, resume, host batches: one folder each, rank 0's
    assert sorted(os.listdir(first["paths"]["checkpoints"])) == ["2.pt", "4.pt"]
    for r in ranks:
        assert r["train"]["losses"] == first["losses"] and len(first["losses"]) == 2
        assert_same(r["train"]["params"], first["params"])
        assert r["resumed"]["step"] == 6 and len(r["resumed"]["losses"]) == 1
        assert_same(r["resumed"]["params"], resumed["params"])
        assert_same(r["host_batches"], ranks[0]["host_batches"])
    assert sorted(os.listdir(resumed["paths"]["checkpoints"])) == ["6.pt"]
    assert not any(torch.equal(resumed["params"][k], first["params"][k])
                   for k in first["params"] if first["params"][k].numel() > 8)


def test_a_signal_on_one_rank_stops_both_at_one_step(two_ranks):
    """SIGTERM on rank 0 during step 2 of 10: both ranks leave train() at
    the next step boundary (neither waits in a collective), and rank 0 logs
    the signal in its run folder and saves the checkpoint of step 3."""
    tmp, _ = two_ranks
    runs = glob.glob(os.path.join(str(tmp), "signalled", "*", "*"))
    assert len(runs) == 1
    assert os.listdir(os.path.join(runs[0], "checkpoints")) == ["3.pt"]
    with open(os.path.join(runs[0], "preemption_log.txt")) as f:
        assert f"signal {int(signal.SIGTERM)}" in f.read()


def test_a_signal_on_a_rank_without_the_run_folder_stops_both(two_ranks):
    """SIGTERM during step 2 on rank 1, whose copy of rank 0's run-folder
    paths does not exist on its host: its handler only raises the flag
    (it writes nothing), both ranks stop at the next step boundary, and
    rank 0 saves the checkpoint of step 3."""
    tmp, _ = two_ranks
    runs = glob.glob(os.path.join(str(tmp), "signalled_elsewhere", "*", "*"))
    assert len(runs) == 1
    assert os.listdir(os.path.join(runs[0], "checkpoints")) == ["3.pt"]
    assert not os.path.exists(os.path.join(runs[0], "preemption_log.txt"))
    assert not os.path.exists(os.path.join(str(tmp), "not_on_this_host"))


@pytest.mark.parametrize("group", [False, True], ids=["no group", "one-rank gloo group"])
def test_one_rank_dp_step_is_the_single_device_step(tmp_path, group):
    """The DP step at one rank is the single-device step, bit for bit (rank
    0 keys its draws as one device does): without a process group, where
    the reduction is the identity, and in a one-rank gloo group, where the
    loss and gradients go through `pmean`'s flat bucket and back."""
    import torch.distributed as dist

    from ctdd_tpu_torch.parallel.dryrun import free_port

    cfg = tiny_cfg(str(tmp_path))
    batch = torch.from_numpy(global_batch(cfg, 2))
    if group:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device="cpu")
        assert mesh.backend == ("gloo" if group else None)
        states = []
        for build in (lambda m, l, t: make_train_step(m, l, t, ema_decay=0.9999),
                      lambda m, l, t: make_dp_train_step(m, l, t, mesh, ema_decay=0.9999)):
            model, state, tx, loss = fresh(cfg)
            step = build(model, loss, tx)
            for _ in range(2):
                state, _ = step(state, batch, SEED)
            states.append(snapshot(state))
    finally:
        if group:
            dist.destroy_process_group()
    for key in ("params", "ema", "mu", "nu"):
        assert_same(states[1][key], states[0][key])


def test_make_mesh_without_a_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.device, mesh.backend) == (1, 0, CPU, None)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(8, device="cpu")


def test_shard_batch_matches_jax_on_the_virtual_mesh():
    import jax

    from ctdd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ctdd_tpu.parallel.mesh import shard_batch as jax_shard_batch

    batch = np.random.RandomState(0).randint(0, 8, (32, 6)).astype(np.int32)
    jax_mesh = jax_make_mesh(8)
    shards = {s.device: np.asarray(s.data)
              for s in jax_shard_batch(batch, jax_mesh).addressable_shards}
    assert len(jax.devices()) == 8
    for r, d in enumerate(jax_mesh.devices.flat):
        got = shard_batch(batch, Mesh(8, r, CPU, "gloo"))
        np.testing.assert_array_equal(got.numpy(), shards[d])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch[:30], Mesh(8, 0, CPU, "gloo"))


def test_dryrun_cli_exits_zero():
    out = subprocess.run([sys.executable, "-m", "ctdd_tpu_torch.parallel.dryrun",
                          "--nprocs", "2", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip(2) ok: loss=" in out.stdout


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    """Without --device the dry run asks for the card (and raises where
    there is none); its backend is NCCL where each process has a card of
    its own, gloo where processes share one or run on the CPU."""
    from ctdd_tpu_torch.parallel import dryrun

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(["--nprocs", "2"])
    spawned = []
    monkeypatch.setattr(dryrun, "spawn", lambda fn, n, *args: spawned.append(args[:2]))
    monkeypatch.setattr(dryrun, "resolve_device",
                        lambda d: torch.device("cuda" if d is None else d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for argv in (["--nprocs", "2"], ["--nprocs", "4"], ["--nprocs", "2", "--device", "cpu"],
                 ["--nprocs", "2", "--backend", "gloo"]):
        dryrun.main(argv)
    assert spawned == [("cuda", "nccl"), ("cuda", "gloo"), ("cpu", "gloo"), ("cuda", "gloo")]


def test_train_cli_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node 2 -m ctdd_tpu_torch.train --device cpu`
    joins the group from torchrun's environment and trains data-parallel:
    one run folder, rank 0's line and checkpoint."""
    from ctdd_tpu_torch.parallel.dryrun import free_port

    tiny = ["data.image_size=8", "data.shape=[1,8,8]", "data.S=8", "model.concat_dim=64",
            "model.ch=8", "model.num_res_blocks=1", "model.ch_mult=[1,2]",
            "model.num_heads=2", "model.attn_resolutions=[4]", "data.batch_size=4",
            "sampler.sample_freq=0", f"data.location={tiny_cfg(str(tmp_path)).data.location}",
            f"save_location={tmp_path / 'runs'}"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(free_port()), "-m", "ctdd_tpu_torch.train",
         "--preset", "tauUnet_mnist", "--device", "cpu", "--iters", "2", "--set", *tiny],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len([s for s in out.stdout.splitlines() if s.startswith("done: step=2")]) == 1
    runs = glob.glob(str(tmp_path / "runs" / "*" / "*"))
    assert len(runs) == 1
    assert os.listdir(os.path.join(runs[0], "checkpoints")) == ["2.pt"]
