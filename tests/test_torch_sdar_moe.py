"""SDAR's block-diffusion training on the port (`networks/sdar_moe.py`, the
absorbing process, `BlockAbsorbingElbo`) against the benchmark's plain
reference family (`h100bench/reference/sdar_moe.py`, loaded by path as the
harness loads it), at the family's tiny widths on the CPU: 2 layers of 64,
4/2 heads of 16, 8 experts of width 32 with 4 held and 2 a token, a
vocabulary of 64, L = 32 in blocks of 4 (8 query tiles of one block), B = 2.

Tolerances: float32 on both sides with the same weights and draws. The
two attentions add in other orders (query tiles over
`scaled_dot_product_attention` against a dense softmax) and the expert
layers scatter in other orders, so the logits differ by float32 rounding
carried through the layers: 1e-5 relative RMS (the readings are ~5e-7).
The loss to 1e-5 relative; each gradient leaf to 1e-4 of its largest
entry (a leaf sums thousands of rounded products; the readings are
~1e-6)."""

import json
import math
from pathlib import Path

import pytest
import torch

from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets import apply_overrides, get_preset
from ctdd_tpu_torch.losses.losses import get_loss
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks import sdar_moe
from ctdd_tpu_torch.ops.forward_process import AbsorbingProcess, build_process
from ctdd_tpu_torch.parallel.dp import make_device_data_train_step
from ctdd_tpu_torch.parallel.mesh import make_mesh
from ctdd_tpu_torch.sampling.samplers import get_sampler
from ctdd_tpu_torch.training.optimizers import get_optimizer
from ctdd_tpu_torch.training.state import create_train_state
from h100bench import common as bench
from h100bench import program
from tests.test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CELL = "sdar_train_b4_l4096"
CONFIG = ROOT / "h100bench" / "configs" / "sdar30b_a3b_l8_e16.json"
SEED = 3000000007


def family():
    return bench.load_module(ROOT / "h100bench" / "reference" / "sdar_moe.py")


def tiny(**model):
    """The benchmark's configuration at the family's tiny widths, with
    `model` overrides: (the plain dict, the program's Config)."""
    cfg = json.loads(CONFIG.read_text())
    cfg = family().shrink(cfg)
    cfg.pop("about")
    cfg["model"].update(model)
    return cfg, program.config(cfg)


def built(**model):
    """(cfg, the program's model, the reference net), one set of seeded
    weights in both."""
    cfg, pcfg = tiny(**model)
    fam = family()
    weights = bench.reference_weights(fam, cfg, SEED, "cpu")
    ref = bench.reference_net(fam, cfg, "cpu", weights)
    return cfg, program.model(pcfg, weights, torch.device("cpu")), ref


def stream(cfg, seed=1, B=2):
    L, S = cfg["data"]["shape"][0], cfg["data"]["S"]
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randint(0, S, (B, L), generator=g, dtype=torch.int32)
    x_t = torch.where(torch.rand((B, L), generator=g) < 0.5, torch.full_like(x0, S), x0)
    return torch.cat([x_t, x0], dim=1)


def rel(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).norm() / b.detach().double().norm())


def test_logits_loss_and_every_gradient_match_the_reference():
    cfg, model, ref = built()
    x = stream(cfg)
    assert rel(model.net(x), ref(x)) < 1e-5
    fam = family()
    x0 = x[:, cfg["data"]["shape"][0]:]
    loss = get_loss(model.cfg).calc_loss(model, model.net, torch.Generator().manual_seed(9), x0)
    terms, _ = fam.per_row_loss(ref, fam.process(cfg, "cpu"), cfg, x0,
                                torch.Generator().manual_seed(9), 0)
    want = terms.mean()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    names = [n for n, _ in ref.named_parameters()]
    mine = dict(zip(names, torch.autograd.grad(loss, [dict(model.net.named_parameters())[n]
                                                      for n in names])))
    theirs = dict(zip(names, torch.autograd.grad(want, list(ref.parameters()))))
    assert set(names) == {n for n, _ in model.net.named_parameters()}
    for n in names:
        scale = float(theirs[n].abs().max())
        assert scale > 0.0, n
        assert float((mine[n] - theirs[n]).abs().max()) <= 1e-4 * scale, n


def test_the_two_shares_add_up_to_the_whole_layer():
    cfg, _ = tiny()
    m = Config(cfg["model"])
    whole = family().Net(dict(cfg, model=dict(cfg["model"], experts_held=8))).layers[0].mlp
    torch.manual_seed(0)
    for p in whole.parameters():
        torch.nn.init.uniform_(p, -0.3, 0.3)
    h = torch.randn(40, m.hidden_size)
    total = torch.zeros_like(h)
    for offset in (0, 4):
        share = sdar_moe.ExpertShare(m.hidden_size, m.moe_intermediate_size, 8, 4, offset,
                                     m.num_experts_per_tok, True, False)
        with torch.no_grad():
            share.gate.weight.copy_(whole.gate.weight)
            for name in ("gate_proj", "up_proj", "down_proj"):
                getattr(share, name).copy_(getattr(whole, name)[offset:offset + 4])
            total += share(h)
    with torch.no_grad():
        want = whole(h)
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())


def hidden_and_logits(model, x):
    seen = []
    hook = model.net.layers[-1].register_forward_hook(lambda mod, a, out: seen.append(out))
    with torch.no_grad():
        logits = model.net(x)
    hook.remove()
    return seen[0], logits


def test_the_mask_noisy_blocks_see_nothing_later_and_clean_never_sees_noisy():
    cfg, model, _ = built()
    L, block, S = cfg["data"]["shape"][0], cfg["model"]["block_length"], cfg["data"]["S"]
    x = stream(cfg)
    hidden, logits = hidden_and_logits(model, x)
    for b in range(L // block):
        later = torch.arange(L)[None, :] // block > b  # noisy: later blocks
        clean_later = torch.arange(L)[None, :] // block >= b  # clean: its own and later
        y = x.clone()
        y[:, :L] = torch.where(later, (y[:, :L] + 1) % S, y[:, :L])
        y[:, L:] = torch.where(clean_later, (y[:, L:] + 1) % S, y[:, L:])
        _, changed = hidden_and_logits(model, y)
        rows = slice(b * block, (b + 1) * block)
        assert torch.equal(changed[:, rows], logits[:, rows]), b
    y = x.clone()
    y[:, :L] = (y[:, :L] + 7) % (S + 1)  # every noisy token, the mask among them
    changed_hidden, changed_logits = hidden_and_logits(model, y)
    assert torch.equal(changed_hidden[:, L:], hidden[:, L:])
    assert not torch.equal(changed_logits, logits)


def test_no_token_is_dropped_when_every_token_goes_to_one_expert():
    d, width = 16, 8
    share = sdar_moe.ExpertShare(d, width, 8, 4, 0, 2, True, False)
    with torch.no_grad():
        share.gate.weight.zero_()
        share.gate.weight[:] = -1.0
        share.gate.weight[0] = 2.0  # every token's first choice: expert 0, held here
        share.gate.weight[7] = 1.0  # its second: expert 7, held elsewhere
    h = torch.rand(300, d) + 0.1
    out = share(h)
    p = torch.softmax(h @ share.gate.weight.T, -1)
    w0 = p[:, 0] / (p[:, 0] + p[:, 7])
    e0 = (torch.nn.functional.silu(h @ share.gate_proj[0].T) * (h @ share.up_proj[0].T)
          ) @ share.down_proj[0].T
    torch.testing.assert_close(out, w0[:, None] * e0, rtol=1e-5, atol=1e-6)
    assert bool((out.abs().sum(-1) > 0).all())


def test_the_absorbing_process_is_closed_form():
    S = 19
    proc = AbsorbingProcess(S, device="cpu")
    held = [v for v in vars(proc).values() if isinstance(v, torch.Tensor)]
    assert all(v.numel() <= S for v in held)
    assert proc.mask_id == S - 1
    n = 100_000
    g = torch.Generator().manual_seed(4)
    x0 = torch.randint(0, S - 1, (n,), generator=g)
    for t in (0.05, 0.3, 0.5, 0.9):
        tt = torch.full((n,), t)
        x_t = proc.corrupt(g, x0, tt)
        share = float((x_t == proc.mask_id).float().mean())
        p = 1.0 - float(proc.keep(tt)[0])
        assert abs(share - p) <= 4.0 * math.sqrt(p * (1.0 - p) / n), t
        assert torch.equal(x_t[x_t != proc.mask_id], x0[x_t != proc.mask_id])
    t = torch.tensor([0.25, 0.5])
    torch.testing.assert_close(proc.mask_rate(t), 1.0 / (1.0 - t))
    torch.testing.assert_close(proc.elbo_weight(t), 1.0 / t)
    _, pcfg = tiny()
    built_proc = build_process(pcfg, device="cpu")
    assert built_proc.S == pcfg.data.S + 1 and built_proc.mask_id == pcfg.data.S


def test_get_sampler_refuses_the_model():
    _, pcfg = tiny()
    with pytest.raises(NotImplementedError, match="no block-diffusion sampler"):
        get_sampler(pcfg)


def test_bf16_moves_the_logits_by_more_than_3x_the_float32_gap():
    cfg, model, ref = built()
    x = stream(cfg)
    want = ref(x)
    gap32 = rel(model.net(x), want)
    _, bf16, _ = built(compute_dtype="bfloat16")
    assert rel(bf16.net(x), want) > 3.0 * gap32


def test_the_counter_counts_one_read_a_layer_and_forward():
    cfg, model, _ = built()
    before = dict(sdar_moe.MOE_HOST_READS)
    with torch.no_grad():
        model.net(stream(cfg))
    assert sdar_moe.MOE_HOST_READS["forwards"] == before["forwards"] + 1
    assert sdar_moe.MOE_HOST_READS["reads"] == before["reads"] + cfg["model"]["num_layers"]


TINY = {"model.num_layers": 2, "model.hidden_size": 64, "model.num_heads": 4,
        "model.num_kv_heads": 2, "model.head_dim": 16, "model.num_experts": 8,
        "model.experts_held": 2, "model.expert_offset": 6, "model.num_experts_per_tok": 2,
        "model.moe_intermediate_size": 32, "model.vocab_size": 32,
        "data.S": 31, "data.shape": [16], "data.batch_size": 2}


def test_the_preset_is_published_and_trains_at_tiny_overrides():
    cfg = get_preset("sdar_30b_a3b")
    m = cfg.model
    assert (m.num_layers, m.hidden_size, m.num_heads, m.num_kv_heads, m.head_dim) == (
        48, 2048, 32, 4, 128)
    assert (m.num_experts, m.experts_held, m.num_experts_per_tok, m.moe_intermediate_size) == (
        128, 128, 8, 768)
    assert (m.vocab_size, cfg.data.S, cfg.data.shape, m.rope_theta, m.rms_norm_eps) == (
        151936, 151935, [32768], 1e6, 1e-6)
    cfg = apply_overrides(cfg, TINY)
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    tx = get_optimizer(cfg)
    state = create_train_state(dict(model.net.named_parameters()), tx)
    step = make_device_data_train_step(model, get_loss(cfg), tx, make_mesh(device="cpu"), 2,
                                       ema_decay=0.9)
    data = torch.randint(0, 31, (8, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in state.params.items()}
    for _ in range(2):
        state, value = step(state, data, 5)
        assert math.isfinite(value) and value > 0.0
    assert all(not torch.equal(before[k], v) for k, v in state.params.items())


def test_the_benchmark_configuration_is_the_preset_cut():
    cfg = json.loads(CONFIG.read_text())
    about = cfg.pop("about")
    cut = {k: cfg[k.split(".")[0]][k.split(".")[1]] for k in about["reduced"]}
    cut.update({"data.S": cfg["data"]["S"], "data.batch_size": cfg["data"]["batch_size"],
                "experiment_name": cfg["experiment_name"],
                "save_location": cfg["save_location"]})
    want = apply_overrides(get_preset("sdar_30b_a3b"), cut).to_dict()
    assert {k: cfg[k] for k in want} == want
    preset = get_preset("sdar_30b_a3b")
    for key, value in about["published"].items():
        group, name = key.split(".")
        assert preset[group][name] == value, key
    fam = family()
    assert fam.forward_flops(cfg, 1) / 1e12 == pytest.approx(5.647, rel=1e-3)
    assert fam.attention_flops(cfg, 1) / fam.forward_flops(cfg, 1) == pytest.approx(0.39, abs=0.01)
    assert sum(p.numel() for p in bench.reference_net(fam, cfg, "meta").parameters()) == \
        about["parameters"]


def test_a_traced_tiny_run_reads_the_new_metrics(tmp_path):
    from h100bench.conftest import NO_CUDA_WAIT, make_tree, run_cell

    tree = make_tree(tmp_path)
    manifest = json.loads((tree / "BENCHMARK.json").read_text())
    # the metrics a traced run reads on the CPU: the spans and the counters
    manifest["per_layer"] = [m for m in manifest["per_layer"]
                             if m["source"] in ("program_span", "program_counter")]
    (tree / "BENCHMARK.json").write_text(json.dumps(manifest))
    code, line, err = run_cell(tree, CELL, fault=NO_CUDA_WAIT, extra=("--trace", "1"))
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    metrics = line["metrics"]
    for name in ("attn_span_ms.train", "moe_span_ms.train", "dense_span_ms.train"):
        assert metrics[name]["value"] > 0.0, name
    assert metrics["moe_host_reads.train"]["value"] == 2.0  # one a layer, two layers
    # the CPU takes F.linear: the kernel ran none of the dense FLOPs
    assert metrics["dense_tf32x3_share.train"]["value"] == 0.0
