"""Binarized MNIST + hollow transformer + CatRM + LBJF.

The port's copy of ctdd_tpu/config/presets/bin_mnist_hollow.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        distributed=False,
        experiment_name='bin_mnist_hollow',
        save_location='runs/bin_mnist_hollow',
        data=dict(
            S=2, batch_size=16, download=False, image_size=28, is_img=True,
            location='data/mnist/binarized_mnist.npy', name='BinMNIST',
            num_samples=8192, shape=[1, 28, 28], shuffle=True, train=True,
            use_augm=False,
        ),
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='reverse_prob', loss_type='rm',
            min_time=0.005, name='CatRM', nll_weight=0.0, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, attention_dropout_rate=0.1, bidir_readout='attention',
            concat_dim=784, dropout_rate=0.1, ema_decay=0.9999, embed_dim=64,
            fix_logistic=False, log_prob='cat', mlp_dim=1024, name='UniVarHollowEMA',
            net_arch='bidir_transformer', nets='bidir_transformer2', num_heads=8,
            num_layers=12, num_output_ffresiduals=2, out_dim=2, qkv_dim=64,
            rate_const=2.3, readout_dim=2, t_func='sqrt_cos', time_scale_factor=1000,
            transformer_norm_type='prenorm', use_cat=False, use_one_hot_input=False,
        ),
        optimizer=dict(
            lr=0.0002, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=False, min_t=0.005,
            name='LBJF', noise_prefix=False, num_corrector_steps=0, num_steps=1000,
            sample_freq=10000, use_fused_update=False,
        ),
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/bin_mnist_hollow/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=2.0, max_t=0.99999, n_iters=500000,
            train_step_name='Standard', warmup=0,
        ),
    ))
