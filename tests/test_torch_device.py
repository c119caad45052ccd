"""The port's constructors run on the GPU unless the caller asks for the CPU.

Without a CUDA device a constructor called without `device` raises the
RuntimeError that names `device="cpu"`; with `device="cpu"` it builds there.
Whether there is a GPU is decided inside each test.
"""

import pytest
import torch

from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.models.base import compose, create_model
from ctdd_tpu_torch.networks.mlp import ResidualMLP
from ctdd_tpu_torch.ops import forward_process as fp
from ctdd_tpu_torch.sampling.samplers import get_initial_samples
from ctdd_tpu_torch.utils.device import resolve_device
from tests.test_torch_unet import one_torch_thread  # noqa: F401


def _cfg():
    return get_preset("mlp_synthetic")


def _net(cfg):
    m = cfg.model
    return ResidualMLP(D=cfg.data.shape[0], S=cfg.data.S, num_layers=1,
                       d_model=8, hidden_dim=8,
                       time_scale_factor=m.time_scale_factor, temb_dim=8)


def _rate_cfg():
    cfg = _cfg()
    cfg.model.rate_name = "UniformRate"
    return cfg


def _initial(dist):
    def build(**kw):
        x = get_initial_samples(torch.Generator().manual_seed(0), 3, 5, 8, dist,
                                initial_dist_std=2.0, **kw)
        assert x.shape == (3, 5) and x.dtype == torch.int32
        return x
    return build


# each constructor returns something with a `.device` (a tensor, a process or a
# model) when called with the keyword arguments it is given
_CONSTRUCTORS = {
    "create_model": lambda **kw: create_model(_cfg(), **kw),
    "compose": lambda **kw: compose(_rate_cfg(), _net(_cfg()), **kw),
    "build_process": lambda **kw: fp.build_process(_rate_cfg(), **kw),
    "make_uniform": lambda **kw: fp.make_uniform(8, 1.5, **kw),
    "make_uniform_variant": lambda **kw: fp.make_uniform_variant(
        3, 2.0, "log_sqr", **kw),
    "make_gaussian_target": lambda **kw: fp.make_gaussian_target(
        8, 6.0, 512.0, 3.0, 100.0, **kw),
    "make_birth_death": lambda **kw: fp.make_birth_death(8, 1.0, 100.0, **kw),
    "get_initial_samples_uniform": _initial("uniform"),
    "get_initial_samples_gaussian": _initial("gaussian"),
}


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_constructor_defaults_to_the_gpu(name):
    if torch.cuda.is_available():
        assert _CONSTRUCTORS[name]().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _CONSTRUCTORS[name]()


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_constructor_builds_on_the_cpu_when_asked(name):
    assert _CONSTRUCTORS[name](device="cpu").device.type == "cpu"


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_resolve_device_returns_the_cpu(device):
    assert resolve_device(device) == torch.device("cpu")


def test_resolve_device_defaults_to_the_gpu():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device("cuda")
