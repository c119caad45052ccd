"""Evaluation CLI of the port: sample from a checkpoint, compute a metric.

Counterpart of the root eval.py of the JAX package, with the same flags and
`--device` (default `cuda`; never falls back). `--ckpt` is a trainer's
checkpoint directory (`<step>.pt` files; the newest unless `--step`) or one
`.pt` file; the config is the preset with the `--set` overrides.

Usage:
  python -m ctdd_tpu_torch.eval --preset mlp_synthetic --ckpt RUN/checkpoints \\
      --metric mmd                              # 25 rounds x 4096 samples
  python -m ctdd_tpu_torch.eval --preset tauUnet_mnist --ckpt RUN/checkpoints \\
      --metric fid --samples 4096 --batch 256 --set sampler.use_fused_update=True
  python -m ctdd_tpu_torch.eval ... --device cpu   # on the CPU

Metrics: mmd, fid (features: inception with weights from
`--inception-weights` or $CTDD_INCEPTION_NPZ, else the seeded random-conv
"lenet" net with a warning; or "trained", a classifier trained on the eval
dataset; `--fid-levels` adds real vs real and noise in the same features),
maze_acc, sudoku_acc, cond_mmd (a prefix-conditional sampler's samples
given ground-truth prefixes, beside the data-vs-data floor and the
shuffled-suffix anchor; on LakhPianoroll also `scale_consistency` and the
rest fractions), save_samples. `--label` and `--cfg-scale`, and D3PM
checkpoints need modules of later slices and raise NotImplementedError.
The last line of the output is one JSON object: the metric, its value, and
the launches of each hand-written kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _checkpoint_path(ckpt: str, step) -> str:
    """`ckpt` itself if it is a file, else `<step>.pt` in that directory."""
    from ctdd_tpu_torch.utils.bookkeeping import CheckpointManager

    if os.path.isfile(ckpt):
        if step is not None:
            raise ValueError("--step picks a checkpoint in a directory; --ckpt is a file")
        return ckpt
    mgr = CheckpointManager(ckpt)
    steps = mgr.all_steps()
    if not steps:
        raise FileNotFoundError(f"no <step>.pt checkpoint in {ckpt}")
    if step is not None and step not in steps:
        raise FileNotFoundError(f"checkpoint step {step} not found; available: {steps}")
    return mgr.path(steps[-1] if step is None else step)


def _refuse_unported(args, cfg):
    if args.label is not None or args.cfg_scale:
        raise NotImplementedError(
            "--label/--cfg-scale need a label-conditional model (DiT, ROADMAP "
            "queue A, the other image networks), ported in a later slice")
    if cfg.loss.name == "d3pm":
        raise NotImplementedError(
            "D3PM checkpoints need the D3PM port (ROADMAP queue A, D3PM), "
            "ported in a later slice")


def _batches(generator, n: int, batch: int, device):
    """(start, size, generator) of each batch of `batch` out of n; batch i
    draws from a generator seeded by SeedSequence([base, i]), base drawn from
    the caller's generator."""
    import torch

    base = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device).item())
    for i, start in enumerate(range(0, n, batch)):
        seed = np.random.SeedSequence([base, i]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=device).manual_seed(int(seed & 0x7FFFFFFFFFFFFFFF))
        yield start, min(batch, n - start), gen


def _batched(sample_fn, batch: int, device):
    """sample_fn(generator, n) in batches of `batch` (`_batches`)."""

    def fn(generator, n):
        return np.concatenate([sample_fn(gen, size)
                               for _, size, gen in _batches(generator, n, batch, device)],
                              axis=0)

    return fn


def _cond_mmd(args, cfg, sampler, model, generator, device) -> dict:
    """Conditional generation: n ground-truth prefixes, the sampler's
    suffixes, and the categorical exp-Hamming MMD of (prefix ⊕ suffix)
    against n other ground-truth sequences, with a median-heuristic
    bandwidth (ln 2 over the median distance of two ground-truth sets), beside
    the data-vs-data floor and the anchor of ground truth with its suffixes
    shuffled across rows. On LakhPianoroll also the share of suffix notes in
    the key of the prefix (`scale_consistency`) and the rest fractions."""
    from ctdd_tpu_torch.data.loaders import get_dataset
    from ctdd_tpu_torch.metrics.mmd import categorical_exp_hamming_mmd

    dataset = get_dataset(cfg)
    cond_dim = int(cfg.sampler.condition_dim)
    n = args.samples
    if len(dataset.data) < 3 * n:
        sys.exit(f"cond_mmd needs >= 3*samples rows ({3 * n}); dataset has "
                 f"{len(dataset.data)}")
    rng = np.random.RandomState(args.seed)
    idx = rng.choice(len(dataset.data), size=3 * n, replace=False)
    gt_a, gt_b, gt_c = (np.asarray(dataset.data[idx[k * n:(k + 1) * n]]) for k in range(3))
    gen = np.concatenate([
        sampler.sample(model, model.net, g, N=m, conditioner=gt_a[start:start + m, :cond_dim])
        for start, m, g in _batches(generator, n, args.batch or n, device)], axis=0)
    shuffled = gt_a.copy()
    shuffled[:, cond_dim:] = gt_a[rng.permutation(n), cond_dim:]
    d_med = np.median((gt_b[:, None, :] != gt_c[None, :, :]).sum(axis=-1))
    bd = float(np.log(2.0) / max(d_med, 1.0))

    def mmd(x):
        return float(categorical_exp_hamming_mmd(x, gt_b, bd))

    out = dict(value=mmd(gen), floor=mmd(gt_c), shuffled=mmd(shuffled), bandwidth=bd,
               n_samples=n, condition_dim=cond_dim)
    print(f"cond_mmd: model={out['value']:.6f} floor(gt-vs-gt)={out['floor']:.6f} "
          f"shuffled-suffix={out['shuffled']:.6f} "
          f"[n={n} cond_dim={cond_dim} bandwidth={bd:.5f}]")
    if cfg.data.name == "LakhPianoroll":
        from ctdd_tpu_torch.data.pianoroll import REST, scale_consistency

        out.update(
            scale_consistency=scale_consistency(gen, cond_dim),
            gt_scale_consistency=scale_consistency(gt_b, cond_dim),
            shuffled_scale_consistency=scale_consistency(shuffled, cond_dim),
            model_rest_frac=float((gen[:, cond_dim:] >= REST).mean()),
            gt_rest_frac=float((gt_b[:, cond_dim:] >= REST).mean()))
        print(f"scale_consistency: model={out['scale_consistency']:.4f} "
              f"gt={out['gt_scale_consistency']:.4f} "
              f"shuffled={out['shuffled_scale_consistency']:.4f} "
              f"model_rest_frac={out['model_rest_frac']:.4f} "
              f"gt_rest_frac={out['gt_rest_frac']:.4f}")
    return out


def _fid(args, cfg, sample_fn, generator, device) -> dict:
    """Sampled images against the training images (the reference protocol:
    the full training split unless --n-real); with --fid-levels also the
    FIDs of as many other training images and of uniform noise, in the same
    features."""
    from ctdd_tpu_torch.data.loaders import get_dataset
    from ctdd_tpu_torch.metrics.fid import (
        activation_statistics, calculate_frechet_distance, get_activations, get_feature_fn,
        trained_classifier_features,
    )

    weights = args.inception_weights or os.environ.get("CTDD_INCEPTION_NPZ", "")
    kind = args.features
    if kind == "auto":
        kind = "inception" if weights and os.path.isfile(weights) else "lenet"
    if kind == "inception":
        from ctdd_tpu_torch.metrics.inception import inception_npz_family

        family = inception_npz_family(weights) if weights else "none (random weights)"
        print(f"Inception weights: family={family} ({weights})")
        if family != "pytorch-fid":
            print(
                f"WARNING: inception npz family is '{family}', not "
                "'pytorch-fid' (pt_inception-2015-12-05, ref "
                "mnist_is.py:15). FIDs from these weights are NOT "
                "comparable to the reference's published numbers — "
                "re-run scripts/convert_inception_weights.py with the "
                "default --family pytorch-fid.",
                file=sys.stderr,
            )
    if kind == "lenet":
        print(
            "WARNING: no InceptionV3 weights found — falling back to the "
            "fixed-seed random-conv feature net. The number below is a "
            "RELATIVE quality signal, NOT comparable to published "
            "Inception FIDs. Drop in converted weights (see "
            "scripts/convert_inception_weights.py) and pass "
            "--inception-weights to reproduce the reference protocol; "
            "or use --features trained for a discriminative relative "
            "metric.",
            file=sys.stderr,
        )
    dataset = get_dataset(cfg)
    shape = tuple(cfg.data.shape)  # (C, H, W)
    samples = sample_fn(generator, args.samples).reshape((-1,) + shape)
    n_real = min(len(dataset.data), args.n_real or len(dataset.data))
    idx = np.arange(len(dataset.data))
    if n_real < len(dataset.data):
        idx = np.random.RandomState(args.seed).choice(len(dataset.data), size=n_real,
                                                      replace=False)
    real = dataset.data[idx].reshape((-1,) + shape)
    feature_kind = kind
    if kind == "trained":
        if dataset.labels is None:
            sys.exit(f"--features trained requires a labeled dataset; "
                     f"{cfg.data.name} has no labels")
        feature_kind = trained_classifier_features(
            dataset.data.reshape((-1,) + shape), dataset.labels, seed=args.seed,
            device=device)
    fn = get_feature_fn(feature_kind, weights if kind == "inception" else None, device=device)
    real_stats = activation_statistics(get_activations(real, fn))

    def fid_of(images):
        return float(calculate_frechet_distance(
            *activation_statistics(get_activations(images, fn)), *real_stats))

    fid = fid_of(samples)
    print(f"FID ({kind}): {fid:.6f}  [n_samples={len(samples)} "
          f"n_real={n_real} sampler={cfg.sampler.name}]")
    out = dict(value=fid, features=kind, n_samples=len(samples), n_real=n_real)
    if args.fid_levels:
        # the same features and real statistics: training images outside the
        # real set, and seeded uniform noise
        rest = np.setdiff1d(np.arange(len(dataset.data)), idx)
        if len(rest) < len(samples):
            raise ValueError(f"--fid-levels needs {len(samples)} images outside the real "
                             f"set; {len(rest)} are left (lower --n-real)")
        noise = np.random.default_rng(args.seed).integers(
            0, 256, samples.shape, dtype=np.uint8)
        out.update(real_vs_real=fid_of(dataset.data[rest[:len(samples)]].reshape(samples.shape)),
                   noise=fid_of(noise))
        print(f"FID ({kind}) levels: real vs real {out['real_vs_real']:.6f}, "
              f"uniform noise {out['noise']:.6f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory (<step>.pt files) or one .pt file")
    ap.add_argument("--metric", default="mmd",
                    choices=["mmd", "fid", "maze_acc", "sudoku_acc",
                             "cond_mmd", "save_samples"])
    # reference MMD protocol: 25 rounds x 4096 samples (eval_synthetic.py:159)
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=True,
                    help="evaluate EMA params (default) or raw params")
    ap.add_argument("--batch", type=int, default=0,
                    help="sampling batch size (0 = all at once)")
    ap.add_argument("--label", default=None,
                    help="comma-separated class labels (a label-conditional "
                         "model; not ported yet)")
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help="classifier-free guidance scale (not ported yet)")
    ap.add_argument("--inception-weights", default=None,
                    help="path to converted InceptionV3 weights npz for FID")
    ap.add_argument("--features", default="auto",
                    choices=["auto", "lenet", "inception", "trained"],
                    help="FID feature net: auto = inception if weights "
                         "present else lenet; trained = classifier trained "
                         "on the eval dataset")
    ap.add_argument("--n-real", type=int, default=0,
                    help="real images in the FID real set (0 = the full dataset)")
    ap.add_argument("--fid-levels", action="store_true",
                    help="also report, in the same features against the same real "
                         "set, the FID of --samples training images outside it and of "
                         "--samples seeded uniform-noise images")
    ap.add_argument("--out", default="samples.npy")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to restore (default: latest)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", nargs="*", default=None,
                    help="key=value config overrides (e.g. "
                         "sampler.name=MidPointTauL sampler.num_steps=1000)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ctdd_tpu_torch.config.presets import apply_overrides, get_preset, parse_overrides
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.ops import kernel_launches, kernel_wrappers
    from ctdd_tpu_torch.sampling.samplers import get_sampler
    from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint
    from ctdd_tpu_torch.utils.device import resolve_device

    cfg = apply_overrides(get_preset(args.preset), parse_overrides(args.set))
    _refuse_unported(args, cfg)
    device = resolve_device(args.device)
    model = create_model(cfg, device=device)
    path = _checkpoint_path(args.ckpt, args.step)
    ckpt = load_checkpoint(path, map_location=device)
    model.net.load_state_dict(ckpt["ema_params"] if args.use_ema else ckpt["params"])
    model.net.eval()
    params = "ema" if args.use_ema else "raw"
    print(f"restored step={int(ckpt['step'])} params={params} ({path})")

    sampler = get_sampler(cfg)

    def sample_fn(generator, n):
        return sampler.sample(model, model.net, generator, N=n)[0]

    if args.batch:
        sample_fn = _batched(sample_fn, args.batch, device)

    for w in kernel_wrappers().values():
        w.launches = 0
    generator = torch.Generator(device=device).manual_seed(args.seed)
    result = {"metric": args.metric}
    if args.metric == "mmd":
        from ctdd_tpu_torch.data.loaders import get_dataset
        from ctdd_tpu_torch.metrics.mmd import eval_mmd

        mmd = eval_mmd(cfg, sample_fn, get_dataset(cfg), n_rounds=args.rounds,
                       n_samples=args.samples, seed=args.seed, device=device)
        print(f"MMD: {mmd:.6f}")
        result.update(value=mmd, rounds=args.rounds, n_samples=args.samples)
    elif args.metric == "fid":
        result.update(_fid(args, cfg, sample_fn, generator, device))
    elif args.metric == "maze_acc":
        from ctdd_tpu_torch.data.maze import maze_acc

        acc = maze_acc(sample_fn(generator, args.samples))
        print(f"maze_acc: {acc:.4f}")
        result.update(value=acc, n_samples=args.samples)
    elif args.metric == "cond_mmd":
        result.update(_cond_mmd(args, cfg, sampler, model, generator, device))
    elif args.metric == "sudoku_acc":
        from ctdd_tpu_torch.data.sudoku import sudoku_acc

        acc = sudoku_acc(sample_fn(generator, args.samples))
        print(f"sudoku_acc: {acc:.4f}")
        result.update(value=acc, n_samples=args.samples)
    else:
        s = sample_fn(generator, args.samples)
        np.save(args.out, s)
        print(f"saved {s.shape} -> {args.out}")
        result.update(value=None, path=args.out, shape=list(s.shape))
    result.update(
        step=int(ckpt["step"]), params=params, sampler=cfg.sampler.name,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        kernel_launches=kernel_launches())
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
