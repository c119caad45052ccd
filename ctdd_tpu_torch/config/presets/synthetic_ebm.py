"""Synthetic 2spirals + binary transformer EBM + BinEBMAux + ExactSampling
(LBJF on the EBM logits with `sampler.name=CRMebmLBJF`).

The port's copy of ctdd_tpu/config/presets/synthetic_ebm.py, same keys and
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
        experiment_name='synthetic_ebm',
        loss=dict(
            ce_coeff=1.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.01, name='BinEBMAux', nll_weight=0.001, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=20.0, attention_dropout_rate=0.1, bidir_readout='attention',
            concat_dim=32, dropout_rate=0.1, ema_decay=0.9999, embed_dim=256,
            fix_logistic=False, is_ebm=True, log_prob='bin_ebm', mlp_dim=512,
            name='UniVarBinaryEBMEMA', net_arch='bidir_transformer',
            nets='bidir_transformer2', num_heads=8, num_layers=3,
            num_output_ffresiduals=2, out_dim=2, qkv_dim=256, rate_const=2.7,
            readout='mlp', readout_dim=2, t_func='log_sqr', time_scale_factor=1000,
            transformer_norm_type='prenorm', use_cat=False, use_one_hot_input=False,
        ),
        optimizer=dict(
            lr=0.0001, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=False, min_t=0.01,
            name='ExactSampling', noise_prefix=False, num_corrector_steps=0,
            num_steps=750, sample_freq=10000, use_fused_update=False,
        ),
        save_location='runs/synthetic_ebm',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/synthetic_ebm/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=5.0, max_t=0.99999, n_iters=3000,
            train_step_name='Standard', warmup=0,
        ),
    ))
