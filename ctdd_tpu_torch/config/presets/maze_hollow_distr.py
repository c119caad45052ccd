"""Maze + hollow bidirectional transformer on a plain UniformRate process.

The port's copy of ctdd_tpu/config/presets/maze_hollow_distr.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=3, batch_size=32, crop_wall=False, download=False, image_size=15,
            is_img=True, limit=1, name='Maze3S', num_samples=6400,
            random_transform=True, shape=[1, 15, 15], shuffle=True, stream_fresh=True,
            train=True, use_augm=False,
        ),
        distributed=False,
        experiment_name='maze_hollow_distr',
        loss=dict(
            ce_coeff=1.0, eps_ratio=1e-09, logit_type='reverse_prob', loss_type='rm',
            min_time=0.01, name='ScoreElbo', nll_weight=0.001, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=20.0, attention_dropout_rate=0.1, bidir_readout='res_concat',
            concat_dim=225, dropout_rate=0.1, ema_decay=0.9999, embed_dim=64,
            fix_logistic=False, log_prob='cat', mlp_dim=256, name='UniformBDTEMA',
            net_arch='bidir_transformer', nets='bidir_transformer2', num_heads=4,
            num_layers=2, num_output_ffresiduals=1, out_dim=3, qkv_dim=64,
            rate_const=0.01, readout_dim=3, t_func='log_sqr', time_scale_factor=1000,
            transformer_norm_type='postnorm', use_cat=False, use_one_hot_input=False,
        ),
        optimizer=dict(
            lr=0.00015, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=True, min_t=0.01,
            name='TauLeaping', noise_prefix=False, num_corrector_steps=0,
            num_steps=1000, sample_freq=10000, use_fused_update=False,
        ),
        save_location='runs/maze_hollow_distr',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/maze_hollow_distr/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=5.0, max_t=0.99999, n_iters=300000,
            train_step_name='Standard', warmup=0,
        ),
    ))
