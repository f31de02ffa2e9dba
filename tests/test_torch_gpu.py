"""The port's CUDA kernels against their plain versions at the flagship
widths. Needs an NVIDIA GPU and nvcc; run on the card with

    python -m pytest tests/test_torch_gpu.py -m gpu

Elsewhere every test skips: the `cuda` fixture decides, at run time.
Tolerances are the ones the kernels state (`diffnet_stack.TOLERANCE`,
`mrf_stage.TOLERANCE`), as max |difference| over the largest |value|.
"""

import pytest
import torch

from bisinger_tpu_torch.ops import diffnet_stack, mrf_stage

pytestmark = pytest.mark.gpu

RK, RD = [3, 7, 11], [[1, 3, 5]] * 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


# (4, 256) and (2, 100) take K1's 8-frame tiles; (32, 1024), the bench's
# shape, and (4, 1100), with a ragged last tile, take its 16-frame tiles
# (B * ceil(T / 16) >= 2 * the H100's 132 SMs)
@pytest.mark.parametrize("B,T", [(4, 256), (2, 100), (32, 1024), (4, 1100)])
def test_residual_stack_kernel_matches_plain(cuda, B, T):
    C, L = 256, 20
    dils = [2 ** (i % 4) for i in range(L)]
    g = torch.Generator(device=cuda).manual_seed(B * T)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    args = (torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
            r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
            r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1))
    before = diffnet_stack.counter.launches
    got = diffnet_stack.residual_stack(*args, dils)
    torch.cuda.synchronize()
    assert diffnet_stack.counter.launches == before + 1
    assert _rel(got, diffnet_stack.residual_stack_plain(*args, dils)) <= diffnet_stack.TOLERANCE


# B=2 with a ragged last chunk, and the four stages of the B=4, T=256 path
@pytest.mark.parametrize("B,U,F", [(2, 2048 + 37, 256), (2, 2048 + 37, 128), (2, 2048 + 37, 64),
                                   (2, 2048 + 37, 32), (4, 2048, 256), (4, 8192, 128),
                                   (4, 16384, 64), (4, 32768, 32)])
def test_mrf_stage_kernel_matches_plain(cuda, B, U, F):
    g = torch.Generator(device=cuda).manual_seed(F)
    x = torch.randn((B, U, F), generator=g, device=cuda)
    n_w = 2 * F * F * sum(k * len(d) for k, d in zip(RK, RD))
    w = torch.randn((n_w,), generator=g, device=cuda) * (7 * F) ** -0.5
    b = 0.1 * torch.randn((18, F), generator=g, device=cuda)
    before = mrf_stage.counter.launches
    got = mrf_stage.mrf_stage(x, w, b, RK, RD)
    torch.cuda.synchronize()
    assert mrf_stage.counter.launches == before + 1
    assert _rel(got, mrf_stage.mrf_stage_plain(x, w, b, RK, RD)) <= mrf_stage.TOLERANCE


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 64, 256), device=cuda, dtype=torch.float64)
    w = torch.zeros((2 * 256 * 256 * 63,), device=cuda)
    b = torch.zeros((18, 256), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        mrf_stage.mrf_stage(x, w, b, RK, RD)
    with pytest.raises(ValueError, match="F in"):
        mrf_stage.mrf_stage(torch.zeros((1, 64, 48), device=cuda),
                            torch.zeros((2 * 48 * 48 * 63,), device=cuda),
                            torch.zeros((18, 48), device=cuda), RK, RD)
