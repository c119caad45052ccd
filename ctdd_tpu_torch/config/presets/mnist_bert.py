"""MNIST + Bert enum transformer + CTElbo + TauL.

The port's copy of ctdd_tpu/config/presets/mnist_bert.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        distributed=False,
        experiment_name='mnist_bert',
        save_location='runs/mnist_bert',
        data=dict(
            S=256, batch_size=64, download=False, image_size=28, is_img=True,
            location='data/mnist/mnist.npz', name='DiscreteMNIST',
            random_flips=False, shape=[1, 28, 28], shuffle=True, train=True,
            use_augm=False,
        ),
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.01, name='CTElbo', nll_weight=0.001, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, attention_dropout_rate=0.1, bidir_readout='attention',
            concat_dim=784, dropout_rate=0.01, ema_decay=0.9999, embed_dim=512,
            fix_logistic=False, is_ebm=False, log_prob='cat', mlp_dim=1024,
            name='UniformBertEMA', net_arch='bidir_transformer',
            nets='bidir_transformer2', num_heads=8, num_layers=2,
            num_output_ffresiduals=2, out_dim=256, qkv_dim=512, rate_const=0.007,
            rate_sigma=6.0, readout='resnet', readout_dim=256, t_func='log',
            time_base=3.0, time_exp=100.0, time_scale_factor=1000,
            transformer_norm_type='prenorm', use_cat=False, use_one_hot_input=False,
        ),
        optimizer=dict(
            lr=0.0002, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=False, min_t=0.01,
            name='TauL', noise_prefix=False, num_corrector_steps=0, num_steps=1000,
            sample_freq=10000, use_fused_update=False,
        ),
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/mnist_bert/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=3.0, max_t=0.99999, n_iters=50000,
            train_step_name='Standard', warmup=0,
        ),
    ))
