"""SDAR-30B-A3B-Chat's block-diffusion training at its published widths
(huggingface.co/JetLM/SDAR-30B-A3B-Chat, config.json, `model_type:
sdar_moe`): 48 layers of 2048, GQA 32/4 heads of 128, RoPE θ 1e6, RMSNorm
eps 1e-6, a router over 128 experts keeping 8 renormalised, SwiGLU experts
of 768, an untied head over the vocabulary of 151,936 (the data's 151,935
ids and the mask as the last), 32,768 positions. Every expert is held.

The port's own preset: the JAX package has no counterpart. What the
config does not give is assumed: the block length 4 and the linear
schedule α_t = 1 - t (MDLM's and BD3-LM's defaults), `loss.min_time`,
Adam's learning rate, the clip and the EMA. A card's share of expert
parallelism holds fewer experts (`model.experts_held`, from
`model.expert_offset`) and routes over all of them; the benchmark's cut is
this preset with overrides (h100bench/configs/sdar30b_a3b_l8_e16.json).
"""

from ctdd_tpu_torch.config.base import Config


def get_config() -> Config:
    return Config(dict(
        distributed=False,
        experiment_name='sdar_30b_a3b',
        save_location='runs/sdar_30b_a3b',
        data=dict(
            S=151935, batch_size=1, name='Tokens', shape=[32768],
        ),
        loss=dict(
            min_time=0.01, name='BlockAbsorbingElbo',
        ),
        model=dict(
            block_length=4, compute_dtype='float32', ema_decay=0.9999,
            expert_offset=0, experts_held=128, head_dim=128, hidden_size=2048,
            moe_intermediate_size=768, name='AbsorbingSDARMoE', norm_topk_prob=True,
            num_experts=128, num_experts_per_tok=8, num_heads=32, num_kv_heads=4,
            num_layers=48, rate_name='Absorbing', rms_norm_eps=1e-06, rope_theta=1000000.0,
            vocab_size=151936,
        ),
        optimizer=dict(
            lr=1e-05, name='Adam',
        ),
        sampler=dict(
            sample_freq=0,
        ),
        saving=dict(
            checkpoint_freq=1000,
        ),
        training=dict(
            clip_grad=True, grad_norm=1.0, max_t=1.0, n_iters=100000,
            train_step_name='Standard', warmup=0,
        ),
    ))
