"""MNIST + UNet + GaussianTargetRate + L_ll (NLLOriginal) + MidPointTauL.

The port's copy of ctdd_tpu/config/presets/mnist_tau_unet_ll.py: the flagship
config with loss.name=NLLOriginal and sampler.name=MidPointTauL, run without
correctors.
"""

from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets.mnist_tau_unet import get_config as _flagship


def get_config() -> Config:
    config = _flagship()
    config.experiment_name = "mnist_ll"
    config.save_location = "runs/mnist_ll"
    config.loss.name = "NLLOriginal"
    config.sampler.name = "MidPointTauL"
    config.sampler.num_corrector_steps = 0
    config.saving.sample_plot_path = "runs/mnist_ll/pngs"
    return config
