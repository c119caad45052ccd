"""Training CLI of the port: a preset, overrides, the training loop.

Usage:
  python -m ctdd_tpu_torch.train --preset tauUnet_mnist \\
      --set data.location=data/mnist/mnist.npz
  python -m ctdd_tpu_torch.train --preset tauUnet_mnist --auto-resume
  python -m ctdd_tpu_torch.train --preset tauUnet_mnist --device cpu --iters 2 \\
      --set model.ch=8 ...

Runs on the GPU unless `--device cpu` is given, and never falls back.
Checkpoints land in <save_location>/<date>/<experiment>_<time>/checkpoints/
as <step>.pt files that `python -m ctdd_tpu_torch.serve --ckpt` serves.

`--profile-steps START,END` traces steps START through END (counted from 0)
with torch.profiler and writes a Chrome trace to <run>/profile/trace.json:
the device's kernels beside the host's ops and the port's named spans
(`ctdd.network`, `ctdd.train.*`, `ctdd.data.pool_wait`;
`ctdd_tpu_torch/utils/trace.py` lists them). Open it in Perfetto or
chrome://tracing.

Data-parallel: under torchrun (which sets WORLD_SIZE and RANK) each process
joins the process group from that environment (NCCL on cards, gloo with
`--device cpu`) and trains one rank, one card a process:
  torchrun --nproc_per_node 4 -m ctdd_tpu_torch.train --preset tauUnet_mnist
"""

from __future__ import annotations

import argparse
import os


def _step_range(text: str) -> tuple:
    """"START,END" -> (START, END), 0 <= START <= END."""
    try:
        start, end = (int(v) for v in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected START,END, got {text!r}") from None
    if not 0 <= start <= end:
        raise argparse.ArgumentTypeError(f"expected 0 <= START <= END, got {text!r}")
    return start, end


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", required=True)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume")
    ap.add_argument(
        "--auto-resume", action="store_true",
        help="resume the run of the last 7 days with an identical config and "
             "the most progress",
    )
    ap.add_argument("--writer", default="numpy", choices=("numpy", "tensorboard", "none"))
    ap.add_argument("--set", nargs="*", default=None, help="key=value overrides")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile-steps", type=_step_range, default=None, metavar="START,END",
                    help="trace steps START..END (inclusive) into <run>/profile/trace.json")
    args = ap.parse_args(argv)

    from ctdd_tpu_torch.config.presets import apply_overrides, get_preset, parse_overrides
    from ctdd_tpu_torch.training.loop import train
    from ctdd_tpu_torch.utils.bookkeeping import check_for_preempted_run

    cfg = apply_overrides(get_preset(args.preset), parse_overrides(args.set))
    mesh = None
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        from ctdd_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

        initialize_multihost(device=args.device)
        mesh = make_mesh(device=args.device)
    if args.auto_resume and args.resume is None:
        found = check_for_preempted_run(cfg.save_location, cfg.experiment_name, cfg)
        if found:
            args.resume = os.path.join(found, "checkpoints")
            print(f"auto-resume: {args.resume}")
    state, info = train(cfg, n_iters=args.iters, seed=args.seed,
                        resume_from=args.resume, writer_kind=args.writer,
                        mesh=mesh, device=args.device, profile_steps=args.profile_steps)
    if mesh is None or mesh.rank == 0:
        print(f"done: step={state.step} steps/sec={info['steps_per_sec']:.3f} "
              f"run={info['paths']['root']}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
