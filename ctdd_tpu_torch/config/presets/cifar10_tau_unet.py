"""CIFAR10 + UNet + CTElboLambda + TauL.

The port's copy of ctdd_tpu/config/presets/cifar10_tau_unet.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        distributed=False,
        experiment_name='cifar10',
        save_location='runs/cifar10',
        data=dict(
            S=256, batch_size=64, download=False, image_size=32,
            location='data/cifar10/cifar10.npz', name='DiscreteCIFAR10',
            random_flips=True, shape=[3, 32, 32], shuffle=True, train=True,
            use_augm=False,
        ),
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.01, name='CTElboLambda', nll_weight=0.0, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, attn_resolutions=[64], ch=128, ch_mult=[1, 2, 2, 2],
            concat_dim=3072, data_min_max=[0, 255], dropout=0.1, ema_decay=0.9999,
            fix_logistic=False, input_channels=3, model_output='logistic_pars',
            name='GaussianTargetRateImageX0PredEMAPaul', num_heads=8, num_res_blocks=2,
            padding=False, rate_sigma=6.0, scale_count_to_put_attn=1,
            skip_rescale=True, time_base=3.0, time_embed_dim=128, time_exp=100.0,
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
            checkpoint_freq=1000, sample_plot_path='runs/cifar10/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=1.0, max_t=1.0, n_iters=500000,
            train_step_name='Standard', warmup=0,
        ),
    ))
