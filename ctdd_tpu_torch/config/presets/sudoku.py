"""Sudoku + DDSM score net + L_ll (NLLOriginal) + LBJF.

The port's copy of ctdd_tpu/config/presets/sudoku.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=9, batch_size=128, download=False, name='SudokuDataset',
            num_samples=12800, seed=0, shape=[81], shuffle=True, stream_fresh=True,
            stream_refresh_period=4, train=True,
        ),
        distributed=False,
        experiment_name='sudoku',
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.001, name='NLLOriginal', nll_weight=0.001,
            one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=512.0, concat_dim=81, ema_decay=0.9999, embed_dim=256,
            log_prob='cat', name='UniVarScoreNetEMA', padding=False, rate_const=0.35,
            t_func='sqrt_cos', time_scale_factor=1000,
        ),
        optimizer=dict(
            lr=0.00015, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=True, min_t=0.001,
            name='LBJF', noise_prefix=False, num_corrector_steps=0, num_steps=1000,
            sample_freq=10000, use_fused_update=False,
        ),
        save_location='runs/sudoku',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/sudoku/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=2.0, max_t=0.99, n_iters=50000,
            train_step_name='Standard', warmup=0,
        ),
    ))
