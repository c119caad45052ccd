"""Maze + protein dilated-conv score net + D3PM baseline.

The port's copy of ctdd_tpu/config/presets/maze_protein_d3pm.py, same keys and
values.
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        data=dict(
            S=3, batch_size=128, crop_wall=False, download=False, image_size=15,
            is_img=True, limit=1, name='Maze3S', num_samples=6400,
            random_transform=True, shape=[1, 15, 15], shuffle=True, stream_fresh=True,
            train=True, use_augm=False,
        ),
        distributed=False,
        experiment_name='maze_protein_d3pm',
        loss=dict(
            ce_coeff=0.0, eps_ratio=1e-09, logit_type='direct', loss_type='rm',
            min_time=0.007, name='d3pm', nll_weight=0.0, one_forward_pass=True,
        ),
        model=dict(
            Q_sigma=20.0, concat_dim=225, dropout_rate=0.1, ema_decay=0.9999,
            embed_dim=200, hybrid_coeff=0.01, is_ebm=False, is_img=True,
            loss_type='hybrid', model_output='logits', model_prediction='x_start',
            name='UniProteinD3PM', num_pixel_vals=3, num_timesteps=1000,
            rate_const=1.7, start=0.02, stop=1.0, t_func='sqrt_cos',
            transition_bands=None, transition_mat_type='uniform', type='cosine',
        ),
        optimizer=dict(
            lr=0.00015, name='Adam',
        ),
        sampler=dict(
            corrector_entry_time=0.0, corrector_step_size_multiplier=1.5,
            eps_ratio=1e-09, initial_dist='uniform', is_ordinal=False, min_t=0.007,
            name='ElboTauL', noise_prefix=False, num_corrector_steps=10,
            num_steps=1000, sample_freq=200000000, use_fused_update=False,
        ),
        save_location='runs/maze_protein_d3pm',
        saving=dict(
            checkpoint_freq=10000, sample_plot_path='runs/maze_protein_d3pm/pngs',
        ),
        training=dict(
            clip_grad=True, grad_norm=35.0, max_t=0.99999, n_iters=300000,
            train_step_name='Standard', warmup=0,
        ),
    ))
