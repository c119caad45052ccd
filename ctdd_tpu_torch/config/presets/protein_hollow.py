"""GRAMPA protein sequences + hollow transformer + CatRM + LBJF.

The port's copy of ctdd_tpu/config/presets/protein_hollow.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=21, batch_size=32, is_img=False,
            location='data/protein/grampa_numarr.npy', name='ProteinGrampa',
            num_samples=8192, shape=[48], shuffle=True,
        ),
        distributed=False,
        experiment_name='protein_hollow',
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='reverse_prob', loss_type='rm',
            min_time=0.01, name='CatRM', nll_weight=0.001, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=20.0, attention_dropout_rate=0.1, bidir_readout='res_concat',
            concat_dim=48, dropout_rate=0.01, ema_decay=0.9999, embed_dim=64,
            fix_logistic=False, log_prob='cat', mlp_dim=128, name='UniformHollowEMA',
            net_arch='bidir_transformer', nets='bidir_transformer2', num_heads=1,
            num_layers=1, num_output_ffresiduals=1, out_dim=21, qkv_dim=64,
            rate_const=0.33, readout_dim=21, t_func='log_sqr', time_scale_factor=1000,
            transformer_norm_type='postnorm', use_cat=True, use_one_hot_input=True,
        ),
        optimizer=dict(
            lr=0.00015, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=False, min_t=0.01,
            name='LBJF', noise_prefix=False, num_corrector_steps=0, num_steps=100,
            sample_freq=10000, use_fused_update=False,
        ),
        save_location='runs/protein_hollow',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/protein_hollow/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=5.0, max_t=0.99999, n_iters=100000,
            train_step_name='Standard', warmup=0,
        ),
    ))
