"""Port serving: checkpoint -> SamplerService -> HTTP round trip (CPU)."""

import json
import os
import queue
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.serving import SamplerService, run_http_server
from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint, save_checkpoint
from tests.test_torch_unet import flagship_cfgs, one_torch_thread  # noqa: F401


def _make_ckpt(tmp_path):
    _, cfg = flagship_cfgs("tiny")
    cfg.sampler.num_steps = 4
    cfg.sampler.use_fused_update = True
    model = create_model(cfg)
    torch.manual_seed(0)
    ema = {k: v + 0.01 for k, v in model.net.state_dict().items()}
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, model.net.state_dict(), ema, step=7, config=cfg)
    return cfg, path, ema


def test_checkpoint_round_trip(tmp_path):
    cfg, path, ema = _make_ckpt(tmp_path)
    ckpt = load_checkpoint(path)
    assert ckpt["step"] == 7
    assert Config(ckpt["config"]).to_dict() == cfg.to_dict()
    assert all(torch.equal(ckpt["ema_params"][k], v) for k, v in ema.items())


def test_sampler_service_and_http(tmp_path):
    cfg, path, ema = _make_ckpt(tmp_path)
    svc = SamplerService(cfg, path, batch=4, device="cpu")
    assert all(torch.equal(svc.model.net.state_dict()[k], v) for k, v in ema.items())
    out = svc.generate(6)  # spans two batches
    assert out.shape == (6, cfg.model.concat_dim)
    assert out.min() >= 0 and out.max() < cfg.data.S

    server = run_http_server(svc, port=0)  # ephemeral port
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "step": 7, "batch": 4,
                          "label_conditional": False}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/generate?n=3") as r:
            payload = json.loads(r.read())
        assert payload["shape"] == [3, cfg.model.concat_dim]
        assert len(payload["samples"]) == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_service_without_cuda_refuses_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg, path, _ = _make_ckpt(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplerService(cfg, path, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplerService(cfg, path, batch=2, device="cuda")


def test_serve_cli_answers_healthz(tmp_path):
    """`python -m ctdd_tpu_torch.serve` on the CPU: warm up, bind, answer."""
    _, path, _ = _make_ckpt(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ctdd_tpu_torch.serve", "--ckpt", path,
         "--port", "0", "--batch", "2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see one_torch_thread
    )
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True
    )
    reader.start()
    try:
        port = None
        while port is None:
            line = lines.get(timeout=120)  # raises queue.Empty on a hang
            m = re.search(r"serving on http://127.0.0.1:(\d+) \(step 7\)", line)
            port = int(m.group(1)) if m else None
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/generate?n=1",
                                    timeout=60) as r:
            assert json.loads(r.read())["shape"] == [1, 64]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
