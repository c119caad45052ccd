"""Maze 3-state + hollow transformer + ScoreElbo + LBJF.

The port's copy of ctdd_tpu/config/presets/maze_hollow.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=3, batch_size=128, crop_wall=False, image_size=15, is_img=True, limit=1,
            name='Maze3S', num_samples=6400, random_transform=True, shape=[1, 15, 15],
            shuffle=True, stream_fresh=True, use_augm=False,
        ),
        distributed=False,
        experiment_name='maze_hollow',
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='reverse_prob', loss_type='rm',
            min_time=0.007, name='ScoreElbo', nll_weight=0.01, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, attention_dropout_rate=0.1, bidir_readout='attention',
            concat_dim=225, dropout_rate=0.1, ema_decay=0.9999, embed_dim=128,
            fix_logistic=False, log_prob='cat', mlp_dim=1024, name='UniVarHollowEMA',
            net_arch='bidir_transformer', nets='bidir_transformer2', num_heads=8,
            num_layers=8, num_output_ffresiduals=2, out_dim=3, qkv_dim=128,
            rate_const=1.7, readout_dim=3, t_func='sqrt_cos', time_scale_factor=1000,
            transformer_norm_type='prenorm', use_cat=False, use_one_hot_input=False,
        ),
        optimizer=dict(
            lr=0.0002, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=True, min_t=0.007,
            name='LBJF', noise_prefix=False, num_corrector_steps=0, num_steps=750,
            sample_freq=10000, use_fused_update=False,
        ),
        save_location='runs/maze_hollow',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/maze_hollow/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=3.0, max_t=0.99999, n_iters=300000,
            train_step_name='Standard', warmup=0,
        ),
    ))
