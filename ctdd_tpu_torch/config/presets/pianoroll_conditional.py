"""Lakh pianoroll (the seeded stand-in where the npy is absent) + sequence
transformer + NLLOriginal + ConditionalTauLeaping on the first 32 tokens.

The port's copy of ctdd_tpu/config/presets/pianoroll_conditional.py, same
keys and values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=129, batch_size=64, location='data/pianoroll/train.npy',
            name='LakhPianoroll', shape=[256], shuffle=True,
        ),
        distributed=False,
        experiment_name='pianoroll_cond',
        loss=dict(
            aux_key_weight=0.0, ce_coeff=0.0, condition_dim=32, eps_ratio=1e-09,
            logit_type='direct', loss_type='rm', min_time=0.01, name='NLLOriginal',
            nll_weight=0.001, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=20.0, aux_key_classes=0, concat_dim=256, d_model=128,
            dim_feedforward=2048, dropout=0.1, ema_decay=0.9999, log_prob='cat',
            name='UniformRateSequenceTransformerEMA', num_heads=8, num_layers=6,
            num_output_FFresiduals=2, qk_norm=True, rate_const=0.03,
            scale_input_embedding=True, temb_dim=128, time_scale_factor=1000,
            use_cat=True, use_one_hot_input=True,
        ),
        optimizer=dict(
            lr=5e-05, name='Adam',
        ),
        sampler=dict(
            condition_dim=32, corrector_entry_time=0.0,
            corrector_step_size_multiplier=1.5, eps_ratio=1e-09, initial_dist='uniform',
            is_ordinal=True, min_t=0.01, name='ConditionalTauLeaping',
            noise_prefix=False, num_corrector_steps=0, num_steps=1000,
            reject_multiple_jumps=True, sample_freq=10000, use_fused_update=False,
        ),
        save_location='runs/pianoroll_cond',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/pianoroll_cond/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=1.0, max_t=0.99999, n_iters=20000,
            train_step_name='Standard', warmup=0,
        ),
    ))
