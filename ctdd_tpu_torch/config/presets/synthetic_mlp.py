"""Synthetic 2spirals + ResidualMLP + UniformRate + CTElbo + LBJF: the
minimal end-to-end slice.

The port's copy of ctdd_tpu/config/presets/synthetic_mlp.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        experiment_name="synthetic_mlp",
        save_location="runs/synthetic_mlp",
        distributed=False,
        loss=dict(
            name="CTElbo", logit_type="direct", loss_type="rm", ce_coeff=0.0,
            eps_ratio=1e-9, nll_weight=0.0, min_time=0.007,
            one_forward_pass=True,
        ),
        training=dict(
            train_step_name="Standard", n_iters=20000, clip_grad=True,
            grad_norm=1.0, warmup=0, max_t=0.99999,
        ),
        data=dict(
            name="SyntheticData", type="2spirals", is_img=False, S=2,
            binmode="gray", int_scale=6003.0107336488345,
            plot_size=4.458594271092115, batch_size=128, shuffle=True,
            shape=[32], location="data/synthetic/data_2spirals.npy",
        ),
        model=dict(
            name="UniformRateResMLP", concat_dim=32, rate_const=2.0,
            Q_sigma=20.0, num_layers=3, d_model=128, hidden_dim=256,
            time_scale_factor=1000, temb_dim=32, ema_decay=0.9999,
            log_prob="cat",
        ),
        optimizer=dict(name="Adam", lr=1.5e-4),
        saving=dict(sample_plot_path="runs/synthetic_mlp/pngs",
                    checkpoint_freq=5000),
        sampler=dict(
            name="LBJF", num_steps=100, min_t=0.007, eps_ratio=1e-9,
            initial_dist="uniform", num_corrector_steps=0,
            corrector_step_size_multiplier=1.5, corrector_entry_time=0.0,
            sample_freq=200000000, is_ordinal=False,
        ),
    ))
