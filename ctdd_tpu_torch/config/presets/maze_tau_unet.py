"""Maze 3-state + padded UNet + UniformVariantRate + CTElbo + LBJF/200.

The port's copy of ctdd_tpu/config/presets/maze_tau_unet.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        experiment_name="maze_unet",
        save_location="runs/maze_unet",
        distributed=False,
        loss=dict(
            name="CTElbo", eps_ratio=1e-9, nll_weight=0.001, min_time=0.001,
            one_forward_pass=True, logit_type="direct", loss_type="rm",
            ce_coeff=0.0,
        ),
        training=dict(
            train_step_name="Standard", n_iters=500000, clip_grad=True,
            grad_norm=1.0, warmup=0, max_t=1.0,
        ),
        data=dict(
            name="Maze3S", train=True, download=False, S=3, batch_size=64,
            stream_fresh=True, shuffle=True, image_size=15, shape=[1, 15, 15],
            use_augm=False, crop_wall=False, limit=1, random_transform=True,
            num_samples=6400,
        ),
        model=dict(
            name="UniVarUnetEMA", ema_decay=0.9999, padding=True, ch=64,
            num_res_blocks=3, ch_mult=[1, 2, 2], input_channels=1,
            scale_count_to_put_attn=1, data_min_max=[0, 2], dropout=0.1,
            skip_rescale=True, time_embed_dim=64, time_scale_factor=1000,
            fix_logistic=False, model_output="logits", num_heads=8,
            attn_resolutions=[32], concat_dim=225, rate_const=2.0,
            t_func="log_sqr", Q_sigma=512.0, image_size=15,
        ),
        optimizer=dict(name="Adam", lr=2e-4),
        saving=dict(checkpoint_freq=10000,
                    sample_plot_path="runs/maze_unet/pngs"),
        sampler=dict(
            name="LBJF", num_steps=200, min_t=0.001, eps_ratio=1e-9,
            initial_dist="uniform", num_corrector_steps=0,
            corrector_step_size_multiplier=1.5, corrector_entry_time=0.0,
            is_ordinal=False, sample_freq=10000, use_fused_update=False,
            noise_prefix=False,
        ),
    ))
