"""The port's named spans (`ctdd_tpu_torch/utils/trace.py`) on the CPU at the
tiny flagship geometry: which spans a train step, a TauL run and a data
pool open under torch.profiler and how they nest, the backward ops' link to
the forward spans, the shared no-op without a profiler, results bit for bit
the same with and without one, and the train CLI's `--profile-steps`."""

import ast
import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ctdd_tpu_torch.config.presets import apply_overrides, get_preset, parse_overrides
from ctdd_tpu_torch.losses.losses import get_loss
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.parallel.dp import make_device_data_train_step
from ctdd_tpu_torch.parallel.mesh import make_mesh
from ctdd_tpu_torch.sampling.samplers import get_sampler
from ctdd_tpu_torch.train import main as train_main
from ctdd_tpu_torch.training.loop import PoolStream
from ctdd_tpu_torch.training.optimizers import get_optimizer
from ctdd_tpu_torch.training.state import create_train_state
from ctdd_tpu_torch.training.train_step import make_device_data_step, make_train_step
from ctdd_tpu_torch.utils import trace
from tests.test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

PACKAGE = Path(trace.__file__).resolve().parents[1]

TINY = ["data.image_size=8", "data.shape=[1,8,8]", "data.S=8", "model.concat_dim=64",
        "model.ch=8", "model.num_res_blocks=1", "model.ch_mult=[1,2]", "model.num_heads=2",
        "model.attn_resolutions=[4]", "data.batch_size=4", "sampler.sample_freq=0"]

TRAIN_TOP = (trace.TRAIN_DRAW, trace.TRAIN_LOSS, trace.TRAIN_BACKWARD, trace.TRAIN_REDUCE,
             trace.TRAIN_LOSS_READ, trace.TRAIN_UPDATE)


def tiny_cfg(*extra):
    return apply_overrides(get_preset("tauUnet_mnist"), parse_overrides(TINY + list(extra)))


def built(step_kind: str):
    """A seeded tiny model, its train state and a step with its arguments
    bound: over a dataset on the device (`device_data`, on the one-rank
    mesh), the same with a reduce (`reduced`, the identity, as on a mesh of
    several ranks) or over a batch the caller supplies (`batch`)."""
    cfg = tiny_cfg()
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    tx = get_optimizer(cfg)
    state = create_train_state(dict(model.net.named_parameters()), tx)
    data = torch.randint(0, 8, (32, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    if step_kind == "device_data":
        step = make_device_data_train_step(model, get_loss(cfg), tx, make_mesh(device="cpu"),
                                           4, ema_decay=0.9)
        return model, state, lambda s: step(s, data, 7)
    if step_kind == "reduced":
        step = make_device_data_step(model, get_loss(cfg), tx, 4, ema_decay=0.9,
                                     reduce=lambda v, g: (v, g))
        return model, state, lambda s: step(s, data, 7)
    step = make_train_step(model, get_loss(cfg), tx, ema_decay=0.9)
    return model, state, lambda s: step(s, data[:4], 7)


def sample_run(model, N=2, steps=3):
    sampler = get_sampler(tiny_cfg(f"sampler.num_steps={steps}",
                                   "sampler.use_fused_update=True"))
    return sampler.sample(model, model.net, torch.Generator().manual_seed(5), N)[0]


def recorded(fn):
    """(what fn returns, [(span, its enclosing spans outermost first)])."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    seen = []
    for e in prof.events():
        if e.name.startswith("ctdd."):
            chain, p = [], e.cpu_parent
            while p is not None:
                if p.name.startswith("ctdd."):
                    chain.insert(0, p.name)
                p = p.cpu_parent
            seen.append((e.name, tuple(chain)))
    return out, seen, prof


def test_span_is_the_shared_noop_without_a_profiler():
    assert trace.span(trace.NETWORK) is trace.NOOP
    assert trace.span(trace.TRAIN_LOSS) is trace.NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span(trace.NETWORK), torch.profiler.record_function)
    assert trace.span(trace.NETWORK) is trace.NOOP


def test_span_names_live_in_one_tuple():
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all(n.startswith("ctdd.") for n in trace.SPANS)
    # no module of the port spells a span's name itself
    for path in sorted(PACKAGE.rglob("*.py")):
        if path.name == "trace.py" and path.parent.name == "utils":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.startswith("ctdd."), (path, node.value)


@pytest.mark.parametrize("step_kind", ["device_data", "batch", "reduced"])
def test_train_step_spans_and_their_nesting(step_kind):
    _, state, step = built(step_kind)
    _, seen, _ = recorded(lambda: step(state))
    top = [n for n in TRAIN_TOP if step_kind == "reduced" or n != trace.TRAIN_REDUCE]
    # a reduce only where the step is given one (not on the one-rank
    # mesh); the network inside the loss
    assert seen == [(n, ()) for n in top[:2]] + [(trace.NETWORK, (trace.TRAIN_LOSS,))] + [
        (n, ()) for n in top[2:]]


def test_sampling_spans_and_their_nesting():
    model, _, _ = built("batch")
    _, seen, _ = recorded(lambda: sample_run(model, steps=3))
    step = [(trace.SAMPLE_STEP, ()), (trace.NETWORK, (trace.SAMPLE_STEP,)),
            (trace.SAMPLE_TABLES, (trace.SAMPLE_STEP,))]
    assert seen == 3 * step + [(trace.SAMPLE_DENOISE, ()),
                               (trace.NETWORK, (trace.SAMPLE_DENOISE,))]


class Pools:
    """A dataset that regenerates a pool of 8 rows an epoch."""

    def __len__(self):
        return 8

    def regenerate(self, epoch):
        return np.full((8, 4), epoch, np.int32)


def test_data_pool_wait_span():
    stream = PoolStream(Pools(), steps_per_epoch=2, period=1, device=torch.device("cpu"),
                        use_async=True)

    def waits():
        first = stream.build(0)
        stream.prefetch(2)
        return first, stream.collect(2)

    (first, second), seen, _ = recorded(waits)
    assert seen == [(trace.DATA_POOL_WAIT, ())] * 2
    assert int(first[0, 0]) == 0 and int(second[0, 0]) == 1


def sdar_step():
    """A tiny step of SDAR's block-diffusion training (the benchmark's
    configuration at its reference family's widths): the attention's and
    the expert layer's spans."""
    from tests.test_torch_sdar_moe import tiny

    _, cfg = tiny()
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    tx = get_optimizer(cfg)
    state = create_train_state(dict(model.net.named_parameters()), tx)
    step = make_device_data_train_step(model, get_loss(cfg), tx, make_mesh(device="cpu"), 2)
    data = torch.randint(0, 63, (8, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    return lambda: step(state, data, 7)


def test_every_span_is_opened_somewhere():
    model, state, step = built("reduced")
    names = {n for n, _ in recorded(lambda: step(state))[1]}
    names |= {n for n, _ in recorded(sdar_step())[1]}
    names |= {n for n, _ in recorded(lambda: sample_run(model, steps=2))[1]}
    names |= {n for n, _ in recorded(lambda: PoolStream(
        Pools(), 2, 1, torch.device("cpu"), False).build(0))[1]}
    assert names == set(trace.SPANS)


def test_backward_ops_map_to_the_forward_spans():
    """Each backward op shares its sequence number with the forward op that
    made its node; that op lies in `ctdd.network` or in the loss."""
    _, state, step = built("device_data")
    _, _, prof = recorded(lambda: step(state))
    events = prof.events()

    def span_of(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("ctdd."):
            p = p.cpu_parent
        return None if p is None else p.name

    backward = "autograd::engine::evaluate_function:"
    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(backward) and \
                span_of(e) in (trace.NETWORK, trace.TRAIN_LOSS):
            forward.setdefault(e.sequence_nr, []).append(span_of(e))
    found = {}
    for e in events:
        if e.name.startswith(backward) and "AccumulateGrad" not in e.name:
            assert span_of(e) == trace.TRAIN_BACKWARD, e.name
            assert e.sequence_nr in forward, e.name
            made = forward[e.sequence_nr][-1]
            found[made] = found.get(made, 0) + 1
    assert set(found) == {trace.NETWORK, trace.TRAIN_LOSS}
    assert found[trace.NETWORK] > found[trace.TRAIN_LOSS] > 0


@pytest.mark.parametrize("step_kind", ["device_data", "batch"])
def test_results_bit_identical_under_a_profiler(step_kind):
    def run():
        model, state, step = built(step_kind)
        losses = []
        for _ in range(2):
            state, value = step(state)
            losses.append(value)
        x = sample_run(model, steps=2)
        return losses, state, x

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    assert plain[0] == traced[0]
    for a, b in ((plain[1].params, traced[1].params), (plain[1].ema_params, traced[1].ema_params)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(plain[2], traced[2])


def test_train_cli_profile_steps(tmp_path):
    path = str(tmp_path / "mnist.npz")
    rng = np.random.default_rng(0)
    np.savez(path, x_train=rng.integers(0, 8, (32, 8, 8)).astype(np.uint8),
             y_train=np.zeros(32, np.int64))
    train_main(["--preset", "tauUnet_mnist", "--device", "cpu", "--iters", "3",
                "--profile-steps", "1,2", "--set", *TINY, f"data.location={path}",
                f"save_location={tmp_path / 'runs'}"])
    traces = glob.glob(str(tmp_path / "runs" / "*" / "*" / "profile" / "trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for n in TRAIN_TOP + (trace.NETWORK,):
        # one rank: no reduce
        assert names.count(n) == (0 if n == trace.TRAIN_REDUCE else 2), n
    assert os.path.getsize(traces[0]) > 0


@pytest.mark.parametrize("bad", ["2,1", "1", "a,b", "-1,2"])
def test_train_cli_refuses_a_bad_step_range(bad, capsys):
    with pytest.raises(SystemExit):
        train_main(["--preset", "tauUnet_mnist", "--profile-steps", bad])
    assert "--profile-steps" in capsys.readouterr().err
