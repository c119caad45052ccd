"""Minimal sampling service: a checkpoint behind a fixed-batch sampler.

Counterpart of ctdd_tpu/serving.py. `SamplerService` loads a port
checkpoint onto one device and serves requests for any n from whole batches
of the fixed size; `run_http_server` exposes it over HTTP with the same
JSON as the JAX service.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ctdd_tpu_torch.utils.device import resolve_device


class SamplerService:
    """Checkpointed model -> thread-safe sample generation at a fixed batch."""

    def __init__(self, cfg, ckpt_path: str, batch: int = 16,
                 use_ema: bool = True, seed: int = 0, device=None):
        from ctdd_tpu_torch.models.base import create_model
        from ctdd_tpu_torch.sampling.samplers import get_sampler
        from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint

        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.model = create_model(cfg, device=self.device)
        self.has_label = self.model.has_label
        ckpt = load_checkpoint(ckpt_path, map_location=self.device)
        self.model.net.load_state_dict(
            ckpt["ema_params"] if use_ema else ckpt["params"]
        )
        self.model.net.eval()
        self.step = int(ckpt["step"])
        self.sampler = get_sampler(cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._lock = threading.Lock()

    def warmup(self):
        """Build the kernels and run one batch ahead of the first request."""
        self._generate_batch(
            torch.Generator(device=self.device).manual_seed(0),
            label=[0] if self.has_label else None,
        )

    def _generate_batch(self, generator, label=None, cfg_scale: float = 0.0) -> np.ndarray:
        if label is not None:
            # the class ids cycled over the batch
            label = np.resize(np.asarray(label, np.int64), self.batch)
        samples, _ = self.sampler.sample(
            self.model, self.model.net, generator, N=self.batch, label=label,
            cfg_scale=cfg_scale,
        )
        return samples

    def generate(self, n: int, label=None, cfg_scale: float = 0.0) -> np.ndarray:
        """n samples from fixed-size batches. `label`, a list of class ids
        cycled over each batch, needs a label-conditional model (DiT);
        `cfg_scale` only acts with a label and is ignored without one."""
        if label is not None and not self.has_label:
            raise ValueError(
                f"model {self.cfg.model.name} is not label-conditional"
            )
        chunks = []
        produced = 0
        while produced < n:
            with self._lock:
                sub = int(torch.randint(0, 2**62, (1,), generator=self._gen,
                                        device=self.device).item())
            gen = torch.Generator(device=self.device).manual_seed(sub)
            chunks.append(self._generate_batch(gen, label=label, cfg_scale=cfg_scale))
            produced += self.batch
        return np.concatenate(chunks, axis=0)[:n]


def run_http_server(service: SamplerService, port: int = 8901):
    """Tiny stdlib HTTP front end: GET /healthz, GET /generate?n=16."""
    import json
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            ...

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                body = json.dumps(
                    {"ok": True, "step": service.step,
                     "batch": service.batch,
                     "label_conditional": service.has_label}
                ).encode()
                self.send_response(200)
            elif url.path == "/generate":
                try:
                    q = parse_qs(url.query)
                    n = int(q.get("n", ["16"])[0])
                    n = max(1, min(n, 4096))
                    label = None
                    if "label" in q:
                        label = [int(c) for c in q["label"][0].split(",")]
                    cfg_scale = float(q.get("cfg_scale", ["0.0"])[0])
                    samples = service.generate(
                        n, label=label, cfg_scale=cfg_scale
                    )
                    body = json.dumps(
                        {"shape": list(samples.shape),
                         "samples": samples.tolist()}
                    ).encode()
                    self.send_response(200)
                except ValueError as e:  # bad request
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(400)
                except Exception as e:  # surface errors as 500 JSON
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
            else:
                body = json.dumps({"error": "unknown path"}).encode()
                self.send_response(404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return HTTPServer(("127.0.0.1", port), Handler)
