"""Sampling service CLI: load a port checkpoint, serve /generate over HTTP.

Usage:
  python -m ctdd_tpu_torch.serve --ckpt ckpt.pt [--batch 16 --port 8901
      --no-ema --device cuda]
  curl 'localhost:8901/generate?n=8'

The config is the one stored in the checkpoint.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--port", type=int, default=8901)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ctdd_tpu_torch.config.base import Config
    from ctdd_tpu_torch.serving import SamplerService, run_http_server
    from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint

    cfg = Config(load_checkpoint(args.ckpt)["config"])
    service = SamplerService(
        cfg, args.ckpt, batch=args.batch, use_ema=not args.no_ema,
        device=args.device,
    )
    print("warming up the sampler ...", flush=True)
    service.warmup()
    server = run_http_server(service, args.port)
    port = server.server_address[1]  # the bound port when --port 0
    print(f"serving on http://127.0.0.1:{port} (step {service.step})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
