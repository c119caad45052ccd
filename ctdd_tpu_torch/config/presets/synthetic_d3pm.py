"""Synthetic 2spirals + Bert enum transformer + D3PM baseline.

The port's copy of ctdd_tpu/config/presets/synthetic_d3pm.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=2, batch_size=128, binmode='gray', int_scale=6003.0107336488345,
            is_img=False, location='data/synthetic/data_2spirals.npy',
            name='SyntheticData', num_samples=100000, plot_size=4.458594271092115,
            shape=[32], shuffle=True, type='2spirals',
        ),
        distributed=False,
        experiment_name='synthetic_d3pm',
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.007, name='d3pm', nll_weight=0.0, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, attention_dropout_rate=0.1, bidir_readout='attention',
            concat_dim=32, dropout_rate=0.1, ema_decay=0.9999, embed_dim=64,
            fix_logistic=False, hybrid_coeff=0.01, is_ebm=False, log_prob='cat',
            loss_type='hybrid', mlp_dim=256, model_output='logits',
            model_prediction='x_start', name='UniBertD3PM',
            net_arch='bidir_transformer', nets='bidir_transformer2', num_heads=8,
            num_layers=3, num_output_ffresiduals=2, num_pixel_vals=2,
            num_timesteps=500, out_dim=2, qkv_dim=64, rate_const=2.0, readout='resnet',
            readout_dim=2, start=0.02, stop=1.0, t_func='sqrt_cos',
            time_scale_factor=1000, transformer_norm_type='prenorm',
            transition_bands=None, transition_mat_type='uniform', type='linear',
            use_cat=True, use_one_hot_input=True,
        ),
        optimizer=dict(
            lr=0.00015, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=False, min_t=0.007,
            name='LBJF', noise_prefix=False, num_corrector_steps=0, num_steps=500,
            sample_freq=10000, use_fused_update=False,
        ),
        save_location='runs/synthetic_d3pm',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/synthetic_d3pm/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=1.0, max_t=0.99999, n_iters=200000,
            train_step_name='Standard', warmup=0,
        ),
    ))
