"""The port's eval and bench CLIs on the CPU at tiny widths, the options
it refuses, the D3PM ancestral path, and the maze and sudoku accuracies against the
JAX package's on seeded boards."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctdd_tpu.data import maze as JM
from ctdd_tpu.data import sudoku as JS
from ctdd_tpu_torch import bench, eval as eval_cli
from ctdd_tpu_torch.config.presets import apply_overrides, get_preset, parse_overrides
from ctdd_tpu_torch.data import maze as TM
from ctdd_tpu_torch.data import sudoku as TS
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.utils.bookkeeping import save_checkpoint
from tests.test_torch_training_loop import TINY, tiny_data
from tests.test_torch_unet import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the residual MLP at a tiny width
MLP = ["model.d_model=16", "model.hidden_dim=16", "model.temb_dim=8", "model.num_layers=1",
       "sampler.num_steps=4"]
# synthetic_d3pm's Bert enum transformer at a tiny width, T=6
D3PM_TINY = ["data.shape=[8]", "model.concat_dim=8", "model.embed_dim=16", "model.qkv_dim=16",
             "model.mlp_dim=32", "model.num_layers=1", "model.num_heads=2",
             "model.num_output_ffresiduals=1", "model.num_timesteps=6"]


def _checkpoint(directory, preset, overrides, step=7):
    """A trainer-style checkpoint directory of `preset` with `overrides`,
    weights drawn as the trainer draws them."""
    cfg = apply_overrides(get_preset(preset), parse_overrides(overrides))
    net = create_model(cfg, device="cpu").net
    net.init_weights(torch.Generator().manual_seed(0))
    sd = net.state_dict()
    save_checkpoint(os.path.join(directory, f"{step}.pt"), sd, sd, step=step, config=cfg)
    return str(directory)


def _run(argv, capsys):
    result = eval_cli.main(argv + ["--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(result))
    return result


def test_eval_mmd_as_a_module(tmp_path):
    """`python -m ctdd_tpu_torch.eval --metric mmd` in a fresh process, 2
    rounds x 64 samples, in batches of 48."""
    over = MLP + ["data.num_samples=500"]
    ckpt = _checkpoint(tmp_path, "mlp_synthetic", over)
    out = subprocess.run(
        [sys.executable, "-m", "ctdd_tpu_torch.eval", "--preset", "mlp_synthetic", "--ckpt",
         ckpt, "--metric", "mmd", "--rounds", "2", "--samples", "64", "--batch", "48",
         "--device", "cpu", "--set", *over],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "restored step=7 params=ema" in out.stdout
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metric"] == "mmd" and np.isfinite(res["value"]) and res["device"] == "cpu"
    assert (res["rounds"], res["n_samples"], res["sampler"]) == (2, 64, "LBJF")
    # on the CPU every wrapper takes its plain version: no launch
    assert res["kernel_launches"] == {"fused_tau_leap_update": 0, "reverse_rates": 0,
                                      "euler_posterior": 0}


@pytest.mark.parametrize("features", ["lenet", "trained"])
def test_eval_fid(tmp_path, capsys, features):
    """The flagship at the tiny geometry, fused TauL, against its npz."""
    data = tiny_data(tmp_path)
    with np.load(data) as f:
        np.savez(data, x_train=f["x_train"], y_train=np.arange(32) % 3)
    over = TINY + ["sampler.num_steps=3", "sampler.use_fused_update=True",
                   f"data.location={data}"]
    ckpt = _checkpoint(tmp_path / "ckpt", "tauUnet_mnist", over)
    res = _run(["--preset", "tauUnet_mnist", "--ckpt", ckpt, "--metric", "fid", "--samples",
                "12", "--batch", "5", "--features", features, "--n-real", "20", "--set", *over],
               capsys)
    assert res["features"] == features and np.isfinite(res["value"]) and res["value"] > 0
    assert (res["n_samples"], res["n_real"], res["sampler"]) == (12, 20, "TauL")


@pytest.mark.parametrize("features", ["lenet", "trained"])
def test_eval_fid_levels_share_the_features(tmp_path, capsys, features):
    """--fid-levels adds real vs real and noise, taken with the same feature
    net: the model's FID is the one the eval gives without the flag."""
    data = tiny_data(tmp_path)
    with np.load(data) as f:
        np.savez(data, x_train=f["x_train"], y_train=np.arange(32) % 3)
    over = TINY + ["sampler.num_steps=2", "sampler.use_fused_update=True",
                   f"data.location={data}"]
    ckpt = _checkpoint(tmp_path / "ckpt", "tauUnet_mnist", over)
    base = ["--preset", "tauUnet_mnist", "--ckpt", ckpt, "--metric", "fid", "--samples", "12",
            "--features", features, "--set", *over]
    plain = _run(base + ["--n-real", "20"], capsys)
    levels = _run(base + ["--n-real", "20", "--fid-levels"], capsys)
    assert levels["value"] == plain["value"] and "real_vs_real" not in plain
    assert np.isfinite(levels["real_vs_real"]) and np.isfinite(levels["noise"])
    assert levels["real_vs_real"] != levels["noise"]
    with pytest.raises(ValueError, match="outside the real set"):
        eval_cli.main(base + ["--n-real", "24", "--fid-levels", "--device", "cpu"])


@pytest.mark.parametrize("metric,D,S", [("maze_acc", 225, 3), ("sudoku_acc", 81, 9),
                                        ("save_samples", 32, 2)])
def test_eval_accuracies_and_save_samples(tmp_path, capsys, metric, D, S):
    """The residual MLP at the board's size stands in for the maze and
    sudoku networks, which are cheaper to skip here: they are scored through
    this CLI in test_torch_maze_presets.py."""
    over = MLP + [f"data.S={S}", f"model.concat_dim={D}", f"data.shape=[{D}]"]
    ckpt = _checkpoint(tmp_path, "mlp_synthetic", over, step=3)
    out = str(tmp_path / "s.npy")
    res = _run(["--preset", "mlp_synthetic", "--ckpt", os.path.join(ckpt, "3.pt"), "--metric",
                metric, "--samples", "6", "--out", out, "--no-use-ema", "--set", *over], capsys)
    assert res["step"] == 3 and res["params"] == "raw"
    if metric == "save_samples":
        s = np.load(out)
        assert s.shape == (6, D) and s.min() >= 0 and s.max() < S
    else:
        assert 0.0 <= res["value"] <= 1.0


@pytest.mark.parametrize("extra,what", [
    (["--label", "1,2"], "label-conditional"),
    (["--cfg-scale", "2.0"], "label-conditional"),
    (["--set", "loss.name=d3pm"], "D3PM"),
])
def test_unported_options_raise(tmp_path, capsys, extra, what):
    """`--label` on a model that is not label-conditional, and `--cfg-scale`
    without `--label`, are refused. `loss.name=d3pm`, refused until the D3PM
    slice, now samples ancestrally: `synthetic_d3pm` at a tiny width (T=6),
    6 samples in batches of 4, states in range."""
    if what == "D3PM":
        over = D3PM_TINY + extra[1:]
        ckpt = _checkpoint(tmp_path, "synthetic_d3pm", over, step=3)
        out = str(tmp_path / "s.npy")
        res = _run(["--preset", "synthetic_d3pm", "--ckpt", ckpt, "--metric", "save_samples",
                    "--samples", "6", "--batch", "4", "--out", out, "--set", *over], capsys)
        s = np.load(out)
        assert res["sampler"] == "D3PM ancestral" and res["shape"] == [6, 8]
        assert s.shape == (6, 8) and s.min() >= 0 and s.max() < 2
        assert sum(res["kernel_launches"].values()) == 0
        return
    with pytest.raises(ValueError, match=what):
        eval_cli.main(["--preset", "mlp_synthetic", "--ckpt", str(tmp_path), "--device",
                       "cpu"] + extra)


def test_checkpoint_path_resolution(tmp_path):
    _checkpoint(tmp_path, "mlp_synthetic", MLP, step=3)
    _checkpoint(tmp_path, "mlp_synthetic", MLP, step=11)
    assert eval_cli._checkpoint_path(str(tmp_path), None).endswith("11.pt")
    assert eval_cli._checkpoint_path(str(tmp_path), 3).endswith("3.pt")
    with pytest.raises(FileNotFoundError, match="available"):
        eval_cli._checkpoint_path(str(tmp_path), 5)
    with pytest.raises(FileNotFoundError):
        eval_cli._checkpoint_path(str(tmp_path / "nothing"), None)


def _maze_boards():
    """Solved mazes, each corrupted once (a path cell turned to a wall, a
    corridor cell to a path), and random boards."""
    solved = JM.maze_gen(limit=6, seed=0, use_native=False).reshape(6, 15, 15)
    rng = np.random.RandomState(0)
    broken = []
    for board in solved:
        for src, dst in ((JM.PATH, JM.WALL), (JM.WAY, JM.PATH)):
            b = board.copy()
            cells = np.argwhere(b == src)
            b[tuple(cells[rng.randint(len(cells))])] = dst
            broken.append(b)
    noise = rng.randint(0, 3, (4, 15, 15))
    return np.concatenate([solved, np.stack(broken), noise]).astype(np.int64)


def test_maze_acc_matches_jax():
    boards = _maze_boards()
    assert TM.maze_acc(boards) == JM.maze_acc(boards)
    assert TM.maze_acc(boards[:6]) == JM.maze_acc(boards[:6]) == 1.0
    assert TM.path_length(boards[0]) == JM.path_length(boards[0])
    for b in boards:
        clean = b.copy()
        clean[clean == TM.PATH] = TM.WAY
        mine, theirs = TM.find_path(clean.copy(), True), JM.find_path(clean.copy(), True)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert np.array_equal(mine, theirs)


def test_sudoku_acc_matches_jax():
    solved = JS.gen_sudoku(5, seed=0, use_native=False).reshape(5, 81) - 1
    rng = np.random.RandomState(1)
    broken = solved.copy()
    broken[np.arange(5), rng.randint(0, 81, 5)] = rng.randint(0, 9, 5)
    swapped = solved.copy()  # rows and columns stay permutations, blocks break
    swapped[:, [0, 3]] = swapped[:, [3, 0]]
    boards = np.concatenate([solved, broken, swapped, rng.randint(0, 9, (3, 81))])
    assert TS.sudoku_acc(boards) == JS.sudoku_acc(boards)
    assert TS.sudoku_acc(solved) == 1.0
    assert TS.sudoku_acc(boards, return_array=True) == JS.sudoku_acc(boards, return_array=True)
    onehot = np.eye(9)[boards]
    assert TS.sudoku_acc(onehot) == JS.sudoku_acc(onehot)


def test_bench_json_on_the_cpu(capsys, monkeypatch):
    """The bench's one JSON line: the JAX bench's metric, unit and extras
    keys, with the baseline ratios null, the bf16 train rate a number and,
    with no peak on the CPU, the MFUs null."""
    monkeypatch.setenv("BENCH_BATCH", "4")
    bench.main(["--device", "cpu", "--set", *TINY, "sampler.num_steps=2"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metric"] == "mnist_taul_samples_per_sec" and res["unit"] == "samples/sec/chip"
    assert res["value"] > 0 and res["vs_baseline"] is None
    ex = res["extras"]
    assert {"sampler_steps", "sample_batch", "plain_samples_per_sec",
            "ctelbo_train_steps_per_sec", "train_batch", "train_vs_baseline", "device",
            "train_flops_per_step", "train_mfu", "bf16_train_steps_per_sec", "bf16_train_mfu",
            "sample_flops_per_sampler_step", "sample_mfu", "peak_flops",
            "fused_samples_per_sec"} <= set(ex)
    assert (ex["sampler_steps"], ex["sample_batch"], ex["train_batch"]) == (2, 256, 4)
    assert ex["device"] == "cpu" and ex["peak_flops"] is None and ex["train_mfu"] is None
    assert ex["bf16_train_steps_per_sec"] > 0 and ex["bf16_train_mfu"] is None
    assert ex["train_vs_baseline"] is None
    assert ex["train_flops_per_step"] > ex["sample_flops_per_sampler_step"] / 256 > 0
    assert min(ex["plain_samples_per_sec"], ex["fused_samples_per_sec"],
               ex["ctelbo_train_steps_per_sec"]) > 0

    monkeypatch.setenv("BENCH_TRAIN_ONLY", "1")
    bench.main(["--device", "cpu", "--set", *TINY])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metric"] == "ctelbo_train_steps_per_sec" and res["value"] > 0
    assert res["extras"]["bf16_train_steps_per_sec"] > 0


def test_bench_peak_table():
    assert bench.peak_flops(torch.device("cpu")) is None
    assert bench.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
