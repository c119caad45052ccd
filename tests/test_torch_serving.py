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

import numpy as np
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
    model = create_model(cfg, device="cpu")
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


class _RecordingSampler:
    """Stands in for the JAX sampler: records what `sample` was given."""

    def __init__(self, D):
        self.D, self.calls = D, []

    def sample(self, model, params, key, N, **kwargs):
        self.calls.append(kwargs)
        return np.zeros((N, self.D), int), None


def _jax_service(cfg):
    """The JAX package's service around an unconditional model, without its
    checkpoint and compile: only the request handling is under test."""
    import jax
    from ctdd_tpu.serving import SamplerService as JaxService

    svc = object.__new__(JaxService)
    svc.cfg, svc.batch, svc.has_label, svc.step = cfg, 4, False, 7
    svc.model = svc.params = None
    svc.sampler = _RecordingSampler(cfg.model.concat_dim)
    svc._key, svc._lock = jax.random.PRNGKey(0), threading.Lock()
    return svc


def _statuses(server, queries):
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    out = {}
    try:
        for q in queries:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/generate?{q}", timeout=120) as r:
                    out[q] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as e:
                out[q] = (e.code, json.loads(e.read()))
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    return out


def test_label_and_cfg_scale_on_an_unconditional_model_as_the_jax_service(tmp_path):
    """`label` on an unconditional model is a bad request (400) and
    `cfg_scale` without a label is ignored (200), in both packages."""
    from ctdd_tpu.serving import run_http_server as jax_run_http_server

    cfg, path, _ = _make_ckpt(tmp_path)
    queries = ["n=2&label=0", "n=2&cfg_scale=1.5", "n=2"]
    jsvc = _jax_service(cfg)
    want = _statuses(jax_run_http_server(jsvc, port=0), queries)
    svc = SamplerService(cfg, path, batch=4, device="cpu")
    got = _statuses(run_http_server(svc, port=0), queries)
    assert [want[q][0] for q in queries] == [400, 200, 200]
    assert [got[q][0] for q in queries] == [400, 200, 200]
    assert got["n=2&label=0"][1] == want["n=2&label=0"][1] == {
        "error": f"model {cfg.model.name} is not label-conditional"}
    assert got["n=2&cfg_scale=1.5"][1]["shape"] == [2, cfg.model.concat_dim]
    assert jsvc.sampler.calls == [{}, {}]  # the JAX service dropped cfg_scale
    with pytest.raises(ValueError, match="not label-conditional"):
        svc.generate(2, label=[0])


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
