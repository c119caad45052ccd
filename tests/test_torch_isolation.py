"""The port stands alone: no module of ctdd_tpu_torch, and neither of the
root scripts chip_smoke.py and compare_kernels.py, imports jax, flax, optax,
orbax, ml_collections, yaml or ctdd_tpu."""

import ast
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_collections", "ctdd_tpu", "orbax",
             "yaml")
SCRIPTS = ("chip_smoke.py", "compare_kernels.py")


def _port_files():
    return sorted((ROOT / "ctdd_tpu_torch").rglob("*.py")) + [ROOT / s for s in SCRIPTS]


def _modules():
    return [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted((ROOT / "ctdd_tpu_torch").rglob("*.py"))
    ]


def test_no_forbidden_import_in_source():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    code = "\n".join([
        "import importlib, runpy, sys",
        f"for m in {FORBIDDEN!r}:",
        "    sys.modules[m] = None",
        f"for m in {_modules()!r}:",
        "    importlib.import_module(m)",
        # imports each script without running its __main__ block
        f"for s in {SCRIPTS!r}:",
        f"    runpy.run_path({str(ROOT)!r} + '/' + s, run_name=s[:-3])",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_training_and_scoring_modules_are_covered():
    """The rglob above reaches the training and scoring slices' modules."""
    assert {"ctdd_tpu_torch.train", "ctdd_tpu_torch.training.loop",
            "ctdd_tpu_torch.training.train_step", "ctdd_tpu_torch.training.optimizers",
            "ctdd_tpu_torch.training.state", "ctdd_tpu_torch.losses.losses",
            "ctdd_tpu_torch.data.images", "ctdd_tpu_torch.data.loaders",
            "ctdd_tpu_torch.utils.math", "ctdd_tpu_torch.eval", "ctdd_tpu_torch.bench",
            "ctdd_tpu_torch.metrics", "ctdd_tpu_torch.metrics.mmd",
            "ctdd_tpu_torch.metrics.fid", "ctdd_tpu_torch.metrics.inception",
            "ctdd_tpu_torch.data.synthetic", "ctdd_tpu_torch.data.maze",
            "ctdd_tpu_torch.data.sudoku"} <= set(_modules())


def test_the_hollow_slice_modules_are_covered():
    """The rglob above reaches the hollow family's modules and presets."""
    assert {"ctdd_tpu_torch.networks.hollow", "ctdd_tpu_torch.networks.common",
            "ctdd_tpu_torch.ops.logprob", "ctdd_tpu_torch.ops.logistic",
            "ctdd_tpu_torch.config.presets.synthetic_hollow",
            "ctdd_tpu_torch.config.presets.synthetic_hollow_rmdirect",
            "ctdd_tpu_torch.config.presets.synthetic_bert",
            "ctdd_tpu_torch.config.presets.synthetic_masked",
            "ctdd_tpu_torch.config.presets.mnist_hollow",
            "ctdd_tpu_torch.config.presets.mnist_hollow_crm",
            "ctdd_tpu_torch.config.presets.mnist_bert"} <= set(_modules())


def test_the_maze_sudoku_protein_slice_modules_are_covered():
    """The rglob above reaches the data generators, the DDSM networks and
    the slice's presets."""
    assert {"ctdd_tpu_torch.data.native", "ctdd_tpu_torch.data.protein",
            "ctdd_tpu_torch.data.maze", "ctdd_tpu_torch.data.sudoku",
            "ctdd_tpu_torch.networks.ddsm",
            "ctdd_tpu_torch.config.presets.maze_hollow",
            "ctdd_tpu_torch.config.presets.maze_bert",
            "ctdd_tpu_torch.config.presets.maze_bert_masked",
            "ctdd_tpu_torch.config.presets.maze_hollow_distr",
            "ctdd_tpu_torch.config.presets.maze_protein",
            "ctdd_tpu_torch.config.presets.protein_hollow",
            "ctdd_tpu_torch.config.presets.sudoku"} <= set(_modules())


def test_the_samplers_ebm_and_conditional_slice_modules_are_covered():
    """The rglob above reaches the EBM and sequence-transformer networks,
    the pianoroll data and the slice's presets."""
    assert {"ctdd_tpu_torch.networks.ebm", "ctdd_tpu_torch.networks.transformer",
            "ctdd_tpu_torch.data.pianoroll", "ctdd_tpu_torch.sampling.samplers",
            "ctdd_tpu_torch.config.presets.synthetic_ebm",
            "ctdd_tpu_torch.config.presets.pianoroll_conditional"} <= set(_modules())


def test_the_generators_build_only_from_the_ports_source():
    """The port's generator library is built from ctdd_tpu_torch/csrc/
    datagen.cpp into ctdd_tpu_torch/csrc/build/, never from or into the JAX
    package's native/."""
    from ctdd_tpu_torch.data import native

    assert native.SOURCE == ROOT / "ctdd_tpu_torch" / "csrc" / "datagen.cpp"
    assert native.library_path().parent == ROOT / "ctdd_tpu_torch" / "csrc" / "build"
    assert native.build() == native.library_path()


def test_eval_and_bench_run_as_modules_with_jax_blocked(tmp_path):
    """`-m ctdd_tpu_torch.eval` and `-m ctdd_tpu_torch.bench` end to end in a
    fresh process where importing JAX fails: an MLP checkpoint's samples,
    and the bench's train step at a tiny width."""
    from ctdd_tpu_torch.config.presets import apply_overrides, get_preset, parse_overrides
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.utils.bookkeeping import save_checkpoint

    mlp = ["model.d_model=8", "model.hidden_dim=8", "model.temb_dim=8", "model.num_layers=1",
           "sampler.num_steps=2"]
    cfg = apply_overrides(get_preset("mlp_synthetic"), parse_overrides(mlp))
    sd = create_model(cfg, device="cpu").net.state_dict()
    save_checkpoint(str(tmp_path / "1.pt"), sd, sd, step=1, config=cfg)
    tiny = ["data.image_size=8", "data.shape=[1,8,8]", "data.S=8", "model.concat_dim=64",
            "model.ch=8", "model.num_res_blocks=1", "model.ch_mult=[1,2]",
            "model.num_heads=2", "model.attn_resolutions=[4]"]
    runs = [("ctdd_tpu_torch.eval", ["--preset", "mlp_synthetic", "--ckpt", str(tmp_path),
                                     "--metric", "save_samples", "--samples", "3", "--out",
                                     str(tmp_path / "s.npy"), "--device", "cpu", "--set", *mlp]),
            ("ctdd_tpu_torch.bench", ["--device", "cpu", "--set", *tiny])]
    code = "\n".join([
        "import os, runpy, sys",
        f"for m in {FORBIDDEN!r}:",
        "    sys.modules[m] = None",
        "import torch",
        "torch.set_num_threads(1)",
        "os.environ['BENCH_TRAIN_ONLY'] = '1'",
        "os.environ['BENCH_BATCH'] = '2'",
        f"for mod, argv in {runs!r}:",
        "    sys.argv = [mod] + argv",
        "    runpy.run_module(mod, run_name='__main__', alter_sys=True)",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert '"metric": "save_samples"' in "\n".join(lines)
    assert '"metric": "ctelbo_train_steps_per_sec"' in lines[-1]
    assert np.load(tmp_path / "s.npy").shape == (3, 32)
