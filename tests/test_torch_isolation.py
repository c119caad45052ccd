"""The port stands alone: no module of ctdd_tpu_torch, and neither of the
root scripts chip_smoke.py and compare_kernels.py, imports jax, flax, optax,
orbax, ml_collections, yaml or ctdd_tpu."""

import ast
import pathlib
import subprocess
import sys

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


def test_the_training_modules_are_covered():
    """The rglob above reaches the training slice's modules."""
    assert {"ctdd_tpu_torch.train", "ctdd_tpu_torch.training.loop",
            "ctdd_tpu_torch.training.train_step", "ctdd_tpu_torch.training.optimizers",
            "ctdd_tpu_torch.training.state", "ctdd_tpu_torch.losses.losses",
            "ctdd_tpu_torch.data.images", "ctdd_tpu_torch.data.loaders",
            "ctdd_tpu_torch.utils.math"} <= set(_modules())
