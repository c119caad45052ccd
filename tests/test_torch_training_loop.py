"""The port's training loop on the CPU at the tiny flagship geometry: run
folders, rolling checkpoints, sample grids, bit-identical resume,
auto-resume discovery, the preemption save, serving a trainer checkpoint,
and the CLI."""

import datetime
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.base import Config, load_config, save_config
from ctdd_tpu_torch.convert import unet_params_from_flax
from ctdd_tpu_torch.networks.unet import UNetWrapper
from ctdd_tpu_torch.config.presets import apply_overrides, parse_overrides
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.serving import SamplerService
from ctdd_tpu_torch.train import main as train_main
from ctdd_tpu_torch.training.loop import train
from ctdd_tpu_torch.utils import bookkeeping
from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint
from tests.test_torch_unet import flagship_cfgs, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["data.image_size=8", "data.shape=[1,8,8]", "data.S=8", "model.concat_dim=64",
        "model.ch=8", "model.num_res_blocks=1", "model.ch_mult=[1,2]", "model.num_heads=2",
        "model.attn_resolutions=[4]", "data.batch_size=4", "sampler.sample_freq=0"]


def tiny_data(tmp_path, n=32):
    """An MNIST-layout npz of states in [0, 8)."""
    path = str(tmp_path / "mnist.npz")
    rng = np.random.default_rng(0)
    np.savez(path, x_train=rng.integers(0, 8, (n, 8, 8)).astype(np.uint8),
             y_train=np.zeros(n, np.int64))
    return path


def tiny_cfg(tmp_path, **over):
    _, cfg = flagship_cfgs("tiny")
    cfg.save_location = str(tmp_path / "runs")
    cfg.data.location = tiny_data(tmp_path)
    cfg.data.batch_size = 4
    cfg.sampler.sample_freq = 0
    for k, v in over.items():
        apply_overrides(cfg, {k.replace("__", "."): v})
    return cfg


def _states_equal(a, b):
    assert (a.step, a.opt_state.count, a.ema_num_updates) == \
        (b.step, b.opt_state.count, b.ema_num_updates)
    for x, y in ((a.params, b.params), (a.ema_params, b.ema_params),
                 (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_train_writes_run_folder(tmp_path):
    cfg = tiny_cfg(tmp_path, saving__checkpoint_freq=1, sampler__sample_freq=5,
                   sampler__num_steps=4, sampler__use_fused_update=True)
    state, info = train(cfg, n_iters=5, device="cpu", log_every=2, profile_steps=(1, 2))
    paths = info["paths"]
    assert os.path.getsize(os.path.join(paths["root"], "profile", "trace.json")) > 0
    assert state.step == 5 and state.opt_state.count == 5 and state.ema_num_updates == 5
    assert load_config(os.path.join(paths["config"], "config.json")).to_dict() == cfg.to_dict()
    assert sorted(os.listdir(paths["checkpoints"])) == ["3.pt", "4.pt", "5.pt"]
    grid = np.load(os.path.join(paths["pngs"], "samples_5.npy"))
    assert grid.shape == (16, 64) and grid.min() >= 0 and grid.max() < 8
    assert len(info["losses"]) == 2 and len(info["step_losses"]) == 5
    assert all(np.isfinite(info["step_losses"]))
    curve = np.load(os.path.join(paths["root"], "loss.npz"))
    np.testing.assert_array_equal(curve["steps"], [2, 4])
    ckpt = load_checkpoint(os.path.join(paths["checkpoints"], "5.pt"))
    assert ckpt["step"] == 5 and ckpt["opt_state"]["count"] == 5
    assert all(torch.equal(ckpt["ema_params"][k], v) for k, v in state.ema_params.items())
    # the network the loop returns carries the trained weights
    net = dict(info["model"].net.named_parameters())
    assert all(torch.equal(net[k], v) for k, v in state.params.items())


def test_kill_and_resume_bit_identical(tmp_path):
    """8 steps straight vs 4 steps, a fresh train() from that checkpoint, 4
    more: params, EMA, mu, nu and the counters equal bit for bit."""
    cfg = tiny_cfg(tmp_path)
    full, _ = train(cfg, n_iters=8, seed=3, device="cpu")
    _, info = train(cfg, n_iters=4, seed=3, device="cpu")
    resumed, info2 = train(cfg, n_iters=8, seed=3, device="cpu",
                           resume_from=info["paths"]["checkpoints"])
    assert len(info2["step_losses"]) == 4
    _states_equal(full, resumed)


def test_restore_names_the_steps_there_are(tmp_path):
    cfg = tiny_cfg(tmp_path, saving__checkpoint_freq=1)
    state, info = train(cfg, n_iters=2, device="cpu")
    mgr = bookkeeping.CheckpointManager(info["paths"]["checkpoints"])
    with pytest.raises(FileNotFoundError, match=r"available: \[1, 2\]"):
        mgr.restore(state, step=7)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        bookkeeping.CheckpointManager(str(tmp_path / "empty")).restore(state)


def _fake_run(save_location, day, name, cfg, steps):
    folder = os.path.join(save_location, day, name)
    os.makedirs(os.path.join(folder, "checkpoints"))
    save_config(cfg, os.path.join(folder, "config", "config.json"))
    for s in steps:
        open(os.path.join(folder, "checkpoints", f"{s}.pt"), "w").close()
    return folder


def test_check_for_preempted_run_picks_most_progress(tmp_path):
    cfg = tiny_cfg(tmp_path)
    other = Config(cfg.to_dict())
    other.optimizer.lr = 1.0
    loc, exp = cfg.save_location, cfg.experiment_name
    today = datetime.datetime.now().strftime("%Y-%m-%d")
    before = (datetime.datetime.now() - datetime.timedelta(days=2)).strftime("%Y-%m-%d")
    old = (datetime.datetime.now() - datetime.timedelta(days=9)).strftime("%Y-%m-%d")
    _fake_run(loc, today, f"{exp}_10-00-00", cfg, [5])
    best = _fake_run(loc, before, f"{exp}_23-59-00", cfg, [7, 10])
    _fake_run(loc, today, f"{exp}_11-00-00", other, [20])  # another config
    _fake_run(loc, today, f"{exp}_12-00-00", cfg, [])  # died before a save
    _fake_run(loc, old, f"{exp}_09-00-00", cfg, [50])  # past the lookback
    assert bookkeeping.check_for_preempted_run(loc, exp, cfg) == best
    assert bookkeeping.check_for_preempted_run(loc, "nothing", cfg) is None


def _preempted_run(cfg):
    """train() that a signal stops: its run folder, after checking the
    exit code, the handlers put back and the log."""
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exit_:
        train(cfg, n_iters=10, seed=3, device="cpu")
    assert exit_.value.code == 0
    assert signal.getsignal(signal.SIGTERM) is previous
    (day,) = os.listdir(cfg.save_location)
    (run,) = os.listdir(os.path.join(cfg.save_location, day))
    root = os.path.join(cfg.save_location, day, run)
    with open(os.path.join(root, "preemption_log.txt")) as f:
        assert f"signal {int(signal.SIGTERM)}" in f.read()
    return root


def test_preemption_saves_and_exits(tmp_path, monkeypatch):
    """SIGTERM in the middle of step 3: the handler logs, step 3 runs to its
    end, and the loop checkpoints the state after it and exits 0; the
    handlers are put back."""
    cfg = tiny_cfg(tmp_path)
    calc = TL.CTElbo.calc_loss

    def calc_loss(self, *a, n_iter=0, **k):
        if n_iter == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return calc(self, *a, n_iter=n_iter, **k)

    monkeypatch.setattr(TL.CTElbo, "calc_loss", calc_loss)
    root = _preempted_run(cfg)
    assert os.listdir(os.path.join(root, "checkpoints")) == ["3.pt"]


@pytest.mark.parametrize("where", ["Adam.update", "TrainState.ema_update"])
def test_preemption_inside_the_update_saves_a_whole_step(tmp_path, monkeypatch, where):
    """SIGTERM while step 3 updates its tensors in place (after Adam has
    moved params, mu and nu; before the EMA moves): the one checkpoint
    equals an uninterrupted run to its step (2 or 3) bit for bit, counters
    included."""
    from ctdd_tpu_torch.training.optimizers import Adam
    from ctdd_tpu_torch.training.state import TrainState

    owner = {"Adam.update": Adam, "TrainState.ema_update": TrainState}[where]
    original = getattr(owner, where.split(".")[1])

    def update(self, *a, **k):
        if where == "Adam.update":  # after the in-place update
            out = original(self, *a, **k)
            if out.count == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        if self.ema_num_updates == 2:  # before it
            os.kill(os.getpid(), signal.SIGTERM)
        return original(self, *a, **k)

    os.makedirs(tmp_path / "cut")
    cfg = tiny_cfg(tmp_path / "cut")
    with monkeypatch.context() as m:
        m.setattr(owner, where.split(".")[1], update)
        root = _preempted_run(cfg)
    (name,) = os.listdir(os.path.join(root, "checkpoints"))
    ckpt = load_checkpoint(os.path.join(root, "checkpoints", name))
    step = ckpt["step"]
    assert name == f"{step}.pt" and step in (2, 3)
    full, _ = train(tiny_cfg(tmp_path), n_iters=step, seed=3, device="cpu")
    opt = ckpt["opt_state"]
    assert (opt["count"], ckpt["ema_num_updates"]) == (step, step)
    for saved, want in ((ckpt["params"], full.params), (ckpt["ema_params"], full.ema_params),
                        (opt["mu"], full.opt_state.mu), (opt["nu"], full.opt_state.nu)):
        assert set(saved) == set(want)
        assert all(torch.equal(saved[k], want[k].detach()) for k in want)


def test_sampler_service_serves_a_trainer_checkpoint(tmp_path):
    cfg = tiny_cfg(tmp_path, sampler__num_steps=4, sampler__use_fused_update=True)
    state, info = train(cfg, n_iters=2, device="cpu")
    path = os.path.join(info["paths"]["checkpoints"], "2.pt")
    svc = SamplerService(Config(load_checkpoint(path)["config"]), path, batch=2, device="cpu")
    assert svc.step == 2
    assert all(torch.equal(svc.model.net.state_dict()[k], v)
               for k, v in state.ema_params.items())
    out = svc.generate(3)
    assert out.shape == (3, 64) and out.min() >= 0 and out.max() < 8


def test_bad_set_key_names_nearest_keys(tmp_path):
    with pytest.raises(KeyError, match="did you mean.*'training'"):
        train_main(["--preset", "tauUnet_mnist", "--device", "cpu",
                    "--set", "trainin.n_iters=5"])
    cfg = apply_overrides(tiny_cfg(tmp_path), parse_overrides(
        ["optimizer.schedule=cosine", "loss.nll_weight=0.5", "data.shape=[1,8,8]"]))
    assert cfg.optimizer.schedule == "cosine" and cfg.loss.nll_weight == 0.5
    assert cfg.data.shape == [1, 8, 8]


def test_cli_defaults_to_the_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_main(["--preset", "tauUnet_mnist", "--iters", "1", "--set",
                    f"save_location={tmp_path}/runs"])


def test_cli_trains_two_steps_on_the_cpu(tmp_path):
    data = tiny_data(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "ctdd_tpu_torch.train", "--preset", "tauUnet_mnist",
         "--device", "cpu", "--iters", "2", "--set", *TINY,
         f"data.location={data}", f"save_location={tmp_path}/runs"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "done: step=2" in out.stdout
    (day,) = os.listdir(tmp_path / "runs")
    (run,) = os.listdir(tmp_path / "runs" / day)
    with open(tmp_path / "runs" / day / run / "config" / "config.json") as f:
        assert json.load(f)["model"]["ch"] == 8
    assert os.listdir(tmp_path / "runs" / day / run / "checkpoints") == ["2.pt"]


def test_init_weights_follow_the_jax_initializers():
    """Leaf by leaf against flax's own init of the tiny flagship: zero where
    flax is zero, and the spread of the draws within 25% (uniform draws of
    64 or more entries; 1e-10-scaled leaves included)."""
    cfg, tcfg = flagship_cfgs("tiny")
    flax = jax.jit(jax_create_model(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32), jnp.full((2,), 0.5))
    want = unet_params_from_flax(jax.tree_util.tree_map(np.asarray, flax), tcfg)
    net = UNetWrapper(tcfg)
    net.init_weights(torch.Generator().manual_seed(0))
    got = net.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if not w.any():
            assert not got[k].any(), k
        elif w.numel() >= 64 and w.std() > 0:
            assert 0.75 < (got[k].std() / w.std()).item() < 1.25, k
    again = UNetWrapper(tcfg)
    again.init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in got.items())


def test_host_batches_skip_the_batch_jax_spends_on_init(tmp_path, monkeypatch):
    """With `training.device_data=False` both packages' train() draw host
    batches from the same seeded stream, and JAX spends the first on
    model.init: the port skips it too, so the batches trained on are the
    same, step for step. Each package's step function is replaced by one
    that records its batch."""
    import ctdd_tpu.training.loop as jax_loop
    import ctdd_tpu.training.train_step as jax_train_step
    from ctdd_tpu.config.presets import get_preset as jax_get_preset
    from ctdd_tpu.parallel.mesh import make_mesh
    from ctdd_tpu.training.loop import train as jax_train
    from ctdd_tpu_torch.training import loop as port_loop

    data = str(tmp_path / "bits.npy")
    np.save(data, np.random.default_rng(0).integers(0, 2, (40, 32)).astype(np.int32))
    jcfg = jax_get_preset("mlp_synthetic")
    with jcfg.unlocked():
        jcfg.data.location, jcfg.data.batch_size = data, 8
        jcfg.training.device_data = False
        jcfg.model.d_model = jcfg.model.hidden_dim = jcfg.model.temb_dim = 8
        jcfg.model.num_layers = 1
        jcfg.sampler.sample_freq = 0
        jcfg.save_location = str(tmp_path / "jax")
    cfg = Config(jcfg.to_dict())
    cfg.save_location = str(tmp_path / "port")
    seen = {"jax": [], "port": []}

    def recorder(name):
        def make(*a, **k):
            def step(state, batch, *rest):
                seen[name].append(np.asarray(batch).copy())
                return state, 0.0
            return step
        return make

    monkeypatch.setattr(jax_train_step, "make_train_step", recorder("jax"))
    monkeypatch.setattr(jax_loop, "make_dp_train_step", recorder("jax"))
    monkeypatch.setattr(port_loop, "make_dp_train_step", recorder("port"))
    jax_train(jcfg, n_iters=3, seed=4, writer_kind="numpy", mesh=make_mesh(1))
    train(cfg, n_iters=3, seed=4, device="cpu")
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)
