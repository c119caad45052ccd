"""MNIST + hollow transformer (attention readout) + CatRM (mle) +
CRMLBJF (= LBJF) with 10 corrector steps.

The port's copy of ctdd_tpu/config/presets/mnist_hollow_crm.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        distributed=False,
        experiment_name='mnist_hollow_crm',
        save_location='runs/mnist_hollow_crm',
        data=dict(
            S=256, batch_size=64, download=False, image_size=28, is_img=True,
            location='data/mnist/mnist.npz', name='DiscreteMNIST',
            random_flips=False, shape=[1, 28, 28], shuffle=True, train=True,
            use_augm=False,
        ),
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='reverse_prob',
            loss_type='mle', min_time=0.005, name='CatRM', nll_weight=0.0,
            one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, attention_dropout_rate=0.1, bidir_readout='attention',
            concat_dim=784, dropout_rate=0.1, ema_decay=0.9999, embed_dim=32,
            fix_logistic=False, log_prob='cat', mlp_dim=512,
            name='GaussianHollowEMA', net_arch='bidir_transformer',
            nets='bidir_transformer2', num_heads=8, num_layers=6,
            num_output_ffresiduals=2, out_dim=256, qkv_dim=32, rate_const=2.1,
            rate_sigma=6.0, readout_dim=256, t_func='sqrt_cos', time_base=3.0,
            time_exp=100.0, time_scale_factor=1000, transformer_norm_type='prenorm',
            use_cat=False, use_one_hot_input=False,
        ),
        optimizer=dict(
            lr=0.0002, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='gaussian', is_ordinal=True, min_t=0.005,
            name='CRMLBJF', noise_prefix=False, num_corrector_steps=10,
            num_steps=1000, sample_freq=10000, use_fused_update=False,
        ),
        saving=dict(
            checkpoint_freq=5000, sample_plot_path='runs/mnist_hollow_crm/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=3.0, max_t=0.99999, n_iters=300000,
            train_step_name='Standard', warmup=0,
        ),
    ))
