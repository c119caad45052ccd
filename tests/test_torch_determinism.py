"""`train()`'s determinism context on a CUDA device: cuDNN deterministic
without its autotuner, and PyTorch's deterministic algorithms (so the
memory-efficient attention backward adds in a fixed order) without the NaN
fill of fresh tensors; the caller's settings come back after the block, also
when it raises. On the CPU the context changes nothing. The card's hold
(two `train()` runs bit-identical) is chip_smoke.py's phase [16](e).

The context only sets flags, so it runs here with a device named "cuda".
"""

import pytest
import torch
import torch.utils.deterministic as det

from ctdd_tpu_torch.utils.device import deterministic_training
from tests.test_torch_unet import one_torch_thread  # noqa: F401


def settings():
    return dict(algorithms=torch.are_deterministic_algorithms_enabled(),
                warn_only=torch.is_deterministic_algorithms_warn_only_enabled(),
                fill=det.fill_uninitialized_memory,
                cudnn_deterministic=torch.backends.cudnn.deterministic,
                cudnn_benchmark=torch.backends.cudnn.benchmark)


@pytest.fixture
def caller(request):
    """The caller's settings for the test (param: algorithms on warn-only,
    or off), restored after it."""
    before = settings()
    on = request.param
    torch.use_deterministic_algorithms(on, warn_only=on)
    det.fill_uninitialized_memory = True
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, on
    yield settings()
    torch.use_deterministic_algorithms(before["algorithms"], warn_only=before["warn_only"])
    det.fill_uninitialized_memory = before["fill"]
    torch.backends.cudnn.deterministic = before["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = before["cudnn_benchmark"]


INSIDE = dict(algorithms=True, warn_only=False, fill=False, cudnn_deterministic=True,
              cudnn_benchmark=False)


@pytest.mark.parametrize("caller", [False, True], indirect=True)
def test_training_context_sets_and_restores(caller):
    with deterministic_training("cuda"):
        assert settings() == INSIDE
    assert settings() == caller


@pytest.mark.parametrize("caller", [False, True], indirect=True)
def test_settings_come_back_when_the_block_raises(caller):
    with pytest.raises(RuntimeError, match="inside"):
        with deterministic_training(torch.device("cuda", 0)):
            raise RuntimeError("inside")
    assert settings() == caller


@pytest.mark.parametrize("caller", [False, True], indirect=True)
def test_nested_contexts_restore_the_callers(caller):
    with deterministic_training("cuda"):
        with deterministic_training("cuda"):
            assert settings() == INSIDE
        assert settings() == INSIDE
    assert settings() == caller


@pytest.mark.parametrize("caller", [False], indirect=True)
def test_the_cpu_is_left_alone(caller):
    with deterministic_training("cpu"):
        assert settings() == caller
