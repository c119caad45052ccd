"""MNIST + UNet + D3PM (discrete time) baseline.

The port's copy of ctdd_tpu/config/presets/mnist_d3pm.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=256, batch_size=64, download=False, image_size=28,
            location='data/mnist/mnist.npz', name='DiscreteMNIST', random_flips=True,
            shape=[1, 28, 28], shuffle=True, train=True, use_augm=False,
        ),
        distributed=False,
        experiment_name='mnist_d3pm',
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.01, name='d3pm', nll_weight=0.0, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, attn_resolutions=[48], ch=96, ch_mult=[1, 2, 2],
            concat_dim=784, data_min_max=[0, 255], dropout=0.1, ema_decay=0.9999,
            fix_logistic=False, hybrid_coeff=0.001, input_channels=1, is_img=True,
            loss_type='hybrid', model_output='logits', model_prediction='x_start',
            name='GaussianTargetRateImageX0PredEMAPaul', num_heads=8,
            num_pixel_vals=256, num_res_blocks=2, num_timesteps=1000, padding=False,
            rate_sigma=6.0, scale_count_to_put_attn=1, skip_rescale=True, start=0.0001,
            stop=0.02, time_base=3.0, time_embed_dim=96, time_exp=100.0,
            time_scale_factor=1000, transition_bands=None,
            transition_mat_type='gaussian', type='linear',
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
        save_location='runs/mnist_d3pm',
        saving=dict(
            checkpoint_freq=1000, sample_plot_path='runs/mnist_d3pm/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=2.0, max_t=1.0, n_iters=600000,
            train_step_name='Standard', warmup=0,
        ),
    ))
