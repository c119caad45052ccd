"""MNIST + UNet + GaussianTargetRate + CTElbo + TauL: the flagship config.

The port's copy of ctdd_tpu/config/presets/mnist_tau_unet.py, same keys and
values. `sampler.use_fused_update` stays off, as there; callers turn it on.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    config = Config()
    config.experiment_name = "mnist"
    config.save_location = "runs/mnist"
    config.distributed = False

    config.loss = loss = Config()
    loss.name = "CTElbo"
    loss.eps_ratio = 1e-9
    loss.nll_weight = 0.0
    loss.min_time = 0.01
    loss.one_forward_pass = True
    loss.logit_type = "direct"

    config.training = training = Config()
    training.train_step_name = "Standard"
    training.n_iters = 600000
    training.clip_grad = True
    training.grad_norm = 2.0
    training.warmup = 0
    training.max_t = 1.0

    config.data = data = Config()
    data.name = "DiscreteMNIST"
    data.train = True
    data.download = False
    data.S = 256
    data.batch_size = 64
    data.shuffle = True
    data.image_size = 28
    data.shape = [1, 28, 28]
    data.random_flips = True
    data.use_augm = False
    data.location = "data/mnist/mnist.npz"

    config.model = model = Config()
    model.name = "GaussianTargetRateImageX0PredEMAPaul"
    model.padding = False
    model.ema_decay = 0.9999
    model.ch = 96
    model.num_res_blocks = 2
    model.ch_mult = [1, 2, 2]
    model.input_channels = 1
    model.scale_count_to_put_attn = 1
    model.data_min_max = [0, 255]
    model.dropout = 0.1
    model.skip_rescale = True
    model.time_embed_dim = model.ch
    model.time_scale_factor = 1000
    model.fix_logistic = False
    model.model_output = "logits"
    model.num_heads = 8
    model.attn_resolutions = [int(model.ch / 2)]
    model.concat_dim = data.image_size * data.image_size * 1
    model.rate_sigma = 6.0
    model.Q_sigma = 512.0
    model.time_exp = 100.0
    model.time_base = 3.0

    config.optimizer = optimizer = Config()
    optimizer.name = "Adam"
    optimizer.lr = 2e-4

    config.saving = saving = Config()
    saving.checkpoint_freq = 1000
    saving.sample_plot_path = "runs/mnist/pngs"

    config.sampler = sampler = Config()
    sampler.name = "TauL"
    sampler.num_steps = 1000
    sampler.min_t = 0.01
    sampler.eps_ratio = 1e-9
    sampler.initial_dist = "gaussian"
    sampler.num_corrector_steps = 10
    sampler.corrector_step_size_multiplier = 1.5
    sampler.corrector_entry_time = 0.0
    sampler.is_ordinal = True
    sampler.sample_freq = 1000
    sampler.use_fused_update = False

    return config
