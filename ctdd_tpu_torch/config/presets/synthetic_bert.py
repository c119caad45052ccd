"""Synthetic 2spirals + Bert-style enum transformer + CTElbo + LBJF.

The port's copy of ctdd_tpu/config/presets/synthetic_bert.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        distributed=False,
        experiment_name='synthetic_bert',
        save_location='runs/synthetic_bert',
        data=dict(
            S=2, batch_size=128, binmode='gray', int_scale=6003.0107336488345,
            is_img=False, location='data/synthetic/data_2spirals.npy',
            name='SyntheticData', plot_size=4.458594271092115, shape=[32],
            shuffle=True, type='2spirals',
        ),
        loss=dict(
            ce_coeff=0, eps_ratio=1e-09, logit_type='direct', min_time=0.007,
            name='CTElbo', nll_weight=0.0, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=20.0, attention_dropout_rate=0.1, concat_dim=32,
            dropout_rate=0.1, ema_decay=0.9999, embed_dim=64, is_ebm=False,
            log_prob='cat', mlp_dim=256, name='UniVarBertEMA', num_heads=8,
            num_layers=3, num_output_ffresiduals=2, out_dim=2, qkv_dim=64,
            rate_const=2.0, readout='resnet', readout_dim=2, t_func='sqrt_cos',
            time_scale_factor=1000, transformer_norm_type='prenorm', use_cat=False,
            use_one_hot_input=False,
        ),
        optimizer=dict(
            lr=0.00015, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=False, min_t=0.007,
            name='LBJF', num_corrector_steps=10, num_steps=500,
            sample_freq=200000000,
        ),
        saving=dict(
            checkpoint_freq=20000, sample_plot_path='runs/synthetic_bert/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=1.0, max_t=0.9999, n_iters=200000,
            train_step_name='Standard', warmup=0,
        ),
    ))
