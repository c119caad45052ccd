"""The 3xTF32 GEMM (`ops/tf32x3_gemm.py`): its plain version and autograd
function against `F.linear`, the accuracy of its arithmetic against
float64, the network's count of its dense FLOPs and the benchmark's reading
of it; and, on the card (`python -m pytest -m cuda tests/`), the kernel at
the SDAR cell's shapes against float64, cuBLAS float32 and single TF32."""

from __future__ import annotations

import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from ctdd_tpu_torch.networks import sdar_moe
from ctdd_tpu_torch.ops import tf32x3_gemm as tg
from h100bench import common as bench

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a worker, as `tests/test_torch_unet.py`'s fixture
    (not imported: this file also runs on the card, where `tests` may name
    another package)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_max(c: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over the largest entry of the float64 reference."""
    return float((c.detach().double() - want.detach()).abs().max() / want.detach().abs().max())


def seeded(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


# (M, K, the weights' rows): a head-like N off the 128 tile, k and v's 512,
# M off the tile, and q, k, v as one product over three weights
SHAPES = {"head_like": (200, 96, (148,)), "kv_512": (131, 64, (512,)),
          "qkv_three": (77, 32, (64, 16, 16))}


@pytest.mark.parametrize("kernel_forward", [True, False], ids=["kernel_forward", "f_linear_forward"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_dense_forward_and_both_gradients_match_f_linear(case, kernel_forward):
    """`linear` through `Dense` against `F.linear` a weight: outputs, the
    input's gradient and each weight's; the forward bit for bit where it
    is `F.linear`'s own."""
    M, K, rows = SHAPES[case]
    x = seeded(M, K, seed=1).requires_grad_()
    ws = [seeded(n, K, seed=2 + i).requires_grad_() for i, n in enumerate(rows)]
    gs = [seeded(M, n, seed=9 + i) for i, n in enumerate(rows)]
    ys = tg.linear(x, *ws, kernel_forward=kernel_forward)
    got = torch.autograd.grad(ys, [x, *ws], gs)
    want_ys = [F.linear(x, w) for w in ws]
    want = torch.autograd.grad(want_ys, [x, *ws], gs)
    assert len(ys) == len(ws)
    for y, want_y in zip(ys, want_ys):
        assert y.shape == want_y.shape
        assert rel_max(y, want_y.double()) <= 1e-6
        assert torch.equal(y, want_y) or kernel_forward
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert rel_max(a, b.double()) <= 1e-6


def test_dense_takes_a_three_axis_input_and_an_unused_output():
    """The network's (B, N, K) input, and a weight whose output reaches no
    loss: its gradient is zero, the others are `F.linear`'s."""
    x = seeded(2, 9, 16, seed=1).requires_grad_()
    ws = [seeded(12, 16, seed=2).requires_grad_(), seeded(8, 16, seed=3).requires_grad_()]
    g = seeded(2, 9, 12, seed=4)
    ys = tg.linear(x, *ws)
    assert [tuple(y.shape) for y in ys] == [(2, 9, 12), (2, 9, 8)]
    dx, dw0, dw1 = torch.autograd.grad(ys[0], [x, *ws], g)
    want = torch.autograd.grad(F.linear(x, ws[0]), [x, ws[0]], g)
    assert rel_max(dx, want[0].double()) <= 1e-6 and rel_max(dw0, want[1].double()) <= 1e-6
    assert not dw1.any()


@pytest.mark.parametrize("form", ["forward", "input_grad", "weight_grad"])
def test_matmul_takes_each_operand_contiguous_or_transposed(form):
    """The three products of a linear layer, as the autograd function hands
    them over, against float64."""
    x, w, g = seeded(70, 40, seed=1), seeded(52, 40, seed=2), seeded(70, 52, seed=3)
    a, b = {"forward": (x, w.t()), "input_grad": (g, w), "weight_grad": (g.t(), x)}[form]
    want = a.double() @ b.double()
    assert rel_max(tg.matmul(a, b), want) <= 1e-6


def test_the_wrapper_reads_the_layout_and_refuses_a_strided_operand():
    m = seeded(6, 8)
    assert tg._major("a", m) == 1 and tg._major("a", m.t()) == 0
    with pytest.raises(ValueError):
        tg._major("a", m[:, ::2])
    with pytest.raises(ValueError):
        tg.matmul(seeded(3, 4), seeded(5, 2))


def test_linear_on_the_cpu_is_f_linear_over_the_weights_rows():
    """On the CPU the forward is `F.linear` a weight, bit for bit, or the
    kernel's arithmetic in `matmul_plain` over the weights' rows."""
    x, ws = seeded(2, 5, 12, seed=1), [seeded(8, 12, seed=2), seeded(4, 12, seed=3)]
    for y, w in zip(tg.linear(x, *ws, kernel_forward=False), ws):
        assert torch.equal(y, F.linear(x, w))
    plain = tg.matmul_plain(x.reshape(10, 12), torch.cat(ws).t()).view(2, 5, 12)
    assert torch.equal(torch.cat(tg.linear(x, *ws), dim=-1), plain)
    launches = tg.matmul.launches
    tg.matmul(x.reshape(10, 12), ws[0].t())
    assert tg.matmul.launches == launches


def test_the_split_rounds_to_nearest_ties_away_and_keeps_the_rest():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    v = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, -(1 + ulp / 2), 1 + 3 * ulp / 2])
    assert tg.tf32_round(v).tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp]
    x = seeded(4096)
    hi, lo = tg.tf32_split(x)
    assert torch.equal(tg.tf32_round(hi), hi) and torch.equal(tg.tf32_round(lo), lo)
    assert float(((hi.double() + lo.double()) - x.double()).abs().div(x.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("K", [2048, 32768])
def test_three_tf32_products_keep_float32_accuracy_and_one_does_not(K):
    """The split's arithmetic at the cell's depths (d and the tokens a step):
    within 2x float32's own error against float64, where a single TF32
    product is more than 100x worse."""
    a, b = seeded(96, K, seed=K), seeded(K, 64, seed=K + 1)
    want = a.double() @ b.double()
    e32 = rel_max(a @ b, want)
    e3 = rel_max(tg.matmul_plain(a, b), want)
    e1 = rel_max(tg.tf32_round(a) @ tg.tf32_round(b), want)
    assert e3 <= 2.0 * e32
    assert e1 > 100.0 * e3


def test_the_network_counts_the_dense_forward_flops_from_the_configuration():
    """One forward's count is the roofline's FLOPs from the configuration's
    shapes: q, k, v and o over the 2L positions, the head over L."""
    from tests.test_torch_sdar_moe import built, stream

    cfg, model, _ = built()
    before = sdar_moe.DENSE_FLOPS["forward"]
    x = stream(cfg, B=3)
    with torch.no_grad():
        model.net(x)
    roofline = bench.load_module(ROOT / "h100bench" / "metrics" / "dense_gemm.roofline.py")
    assert sdar_moe.DENSE_FLOPS["forward"] - before == roofline.dense_forward_flops(cfg, 3)


def test_the_share_is_the_kernel_flops_over_three_forwards(monkeypatch):
    share = bench.load_module(ROOT / "h100bench" / "metrics" / "dense_tf32x3_share.train.py")
    ctx = SimpleNamespace(counters={"ranks": 1})
    monkeypatch.setitem(sdar_moe.DENSE_FLOPS, "forward", 0)
    assert share.read(ctx) is None
    monkeypatch.setitem(sdar_moe.DENSE_FLOPS, "forward", 1000)
    monkeypatch.setattr(tg.matmul, "flops", 3000)
    assert share.read(ctx) == 100.0
    monkeypatch.setattr(tg.matmul, "flops", 1500)
    assert share.read(ctx) == 50.0
    assert share.read(SimpleNamespace(counters={"ranks": 4})) is None


# the SDAR cell's products (B = 4, L = 4096, 2L positions): (name, M, N, K)
# of the forward; each also runs as its input's and its weight's gradient.
# "ragged" is off every tile in M, N and K in each of the three forms.
CELL = [("qkv", 32768, 5120, 2048), ("o", 32768, 2048, 4096), ("head", 16384, 18992, 2048),
        ("ragged", 130, 324, 96)]


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,M,N,K", CELL)
def test_the_kernel_at_the_cells_shapes_on_the_card(name, M, N, K):
    """Each of forward, input gradient and weight gradient against float64
    on the first and the last 256 rows of the result (the last holds the
    ragged tile and the last persistent wave): at most 4x cuBLAS float32's
    largest relative error and more than 100x below a single TF32
    product's."""
    dev = needs_cuda()
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    x = torch.randn(M, K, device=dev, generator=g)
    w = torch.randn(N, K, device=dev, generator=g)
    gy = torch.randn(M, N, device=dev, generator=g)
    forms = {"forward": (x, w.t()), "input_grad": (gy, w), "weight_grad": (gy.t(), x)}
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for form, (a, b) in forms.items():
            launches = tg.matmul.launches
            c = tg.matmul(a, b)
            assert tg.matmul.launches == launches + 1
            for rows in (slice(0, 256), slice(-256, None)):
                want = a[rows].double() @ b.double()
                torch.backends.cuda.matmul.allow_tf32 = False
                e32 = rel_max(a[rows] @ b, want)
                torch.backends.cuda.matmul.allow_tf32 = True
                e1 = rel_max(a[rows] @ b, want)
                torch.backends.cuda.matmul.allow_tf32 = False
                e3 = rel_max(c[rows], want)
                assert math.isfinite(e3) and e3 <= 4.0 * e32, (form, rows, e3, e32)
                assert e1 > 100.0 * e3, (form, rows, e1, e3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_the_projections_forward_is_cublas_bit_for_bit_on_the_card():
    """q, k and v at the cell's shapes with `kernel_forward=False`: each
    output is `F.linear`'s own, bit for bit, and the backward launches the
    kernel twice."""
    dev = needs_cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(4, 8192, 2048, device=dev, generator=g).requires_grad_()
    ws = [(torch.randn(n, 2048, device=dev, generator=g) / 45).requires_grad_()
          for n in (4096, 512, 512)]
    ys = tg.linear(x, *ws, kernel_forward=False)
    for y, w in zip(ys, ws):
        assert torch.equal(y, F.linear(x, w))
    launches = tg.matmul.launches
    torch.autograd.grad(ys, [x, *ws], [torch.ones_like(y) for y in ys])
    assert tg.matmul.launches == launches + 2
