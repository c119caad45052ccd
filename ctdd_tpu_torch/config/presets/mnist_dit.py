"""MNIST + DiT + NLL + TauL.

The port's copy of ctdd_tpu/config/presets/mnist_dit.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        distributed=False,
        experiment_name='mnist_dit',
        save_location='runs/mnist_dit',
        data=dict(
            S=256, batch_size=64, download=False, image_size=28,
            location='data/mnist/mnist.npz', name='DiscreteMNIST', random_flips=False,
            shape=[1, 28, 28], shuffle=True, train=True, use_augm=False,
        ),
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.01, name='NLL', nll_weight=0.0, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, concat_dim=784, data_min_max=[0, 255], depth=7, dropout=0.1,
            ema_decay=0.9999, fix_logistic=False, hidden_dim=512, input_channel=1,
            mlp_ratio=4.0, model_output='logistic_pars', name='GaussianDiTEMA',
            num_heads=8, patch_size=4, rate_sigma=6.0, time_base=3.0, time_exp=100.0,
            time_scale_factor=1000,
        ),
        optimizer=dict(
            lr=0.0002, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='gaussian', is_ordinal=True, min_t=0.01,
            name='TauL', noise_prefix=False, num_corrector_steps=0, num_steps=1000,
            sample_freq=10000, use_fused_update=False,
        ),
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/mnist_dit/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=1.0, max_t=1.0, n_iters=600000,
            train_step_name='Standard', warmup=0,
        ),
    ))
