"""Tests that need the card: the CUDA kernels against their plain PyTorch
versions on CUDA tensors.  Marked ``gpu``; without a CUDA device they skip
(decided inside the fixture, never at import).  Run them on a machine with
an NVIDIA GPU and ``nvcc``::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparison at ResNet-8's full width.
"""
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import conv2d_offload as conv
from repro_torch.reference_io import layer_from_numpy

pytestmark = pytest.mark.gpu

# float32: f32 sums of at most 75 products in another order; bfloat16: one
# final rounding to bfloat16 apart.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}

CASES = [
    (2, 10, 12, 3, 3, 3, 1, 1, 5),
    (1, 9, 9, 2, 3, 3, 1, 1, 7),
    (2, 11, 13, 3, 3, 3, 2, 2, 3),
    (3, 12, 14, 4, 5, 3, 1, 2, 2),
    (1, 8, 8, 2, 1, 1, 1, 1, 4),
    (2, 13, 11, 3, 3, 3, 3, 1, 9),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["zigzag", "row"])
@pytest.mark.parametrize("c_in,h,w,n,kh,kw,sh,sw,t_run", CASES)
def test_cuda_kernels_match_their_plain_versions(card, order, c_in, h, w, n,
                                                 kh, kw, sh, sw, t_run,
                                                 dtype):
    rng = np.random.default_rng(5)
    x, k = layer_from_numpy(rng.standard_normal((c_in, h, w)),
                            rng.standard_normal((n, c_in, kh, kw)),
                            device=card, dtype=dtype)
    kw_ = dict(t_run=t_run, s_h=sh, s_w=sw, order=order)
    before = dict(conv.LAUNCHES)
    for name, kernel, plain in (
            ("conv2d_offload", conv.conv2d_offload,
             conv.conv2d_offload_plain),
            ("conv2d_offload_planned", conv.conv2d_offload_planned,
             conv.conv2d_offload_planned_plain)):
        got = kernel(x, k, **kw_)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == dtype
        assert conv.LAUNCHES[name] == before[name] + 1
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   plain(x, k, **kw_).float().cpu().numpy(),
                                   **TOL[dtype])


def test_planned_kernel_refuses_more_than_one_blocks_shared_memory(card):
    x = torch.zeros((512, 6, 6), device=card)
    k = torch.zeros((512, 512, 3, 3), device=card)       # Λ alone is 9 MB
    with pytest.raises(KernelShapeError, match="shared memory"):
        conv.conv2d_offload_planned(x, k, t_run=4)
