"""The port's CUDA kernels against their plain versions at the flagship
widths and at every other width each is built for. Needs an NVIDIA GPU
and nvcc; run on the card with

    python -m pytest tests/test_torch_gpu.py -m gpu

Elsewhere every test skips: the `cuda` fixture decides, at run time.
Tolerances are the ones the kernels state (`diffnet_stack.TOLERANCE`,
`mrf_stage.TOLERANCE`, and `TOLERANCE_BF16` of each for the bf16 routes),
as max |difference| over the largest |value|; the bf16 routes also hold
`MEAN_TOLERANCE_BF16`, mean |difference| over mean |value|. The fp32
routes run on the TF32 tensor cores in 3xTF32 and must also sit at least
10x under their single-pass TF32 control (`ops/_tf32.py`).
"""

import pytest
import torch

from bisinger_tpu_torch.ops import _tf32, diffnet_stack, mrf_stage

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


def _mean_rel(got, ref):
    return ((got - ref).abs().mean() / ref.abs().mean()).item()


# (4, 256), (2, 100) and (4, 1100), with a ragged last tile, take K1's
# 16-frame tiles over clusters of two; (32, 1024), the bench's shape, its
# 64-frame tiles (B * ceil(T / 64) >= the H100's 132 SMs)
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
    with pytest.raises(ValueError, match="takes widths"):
        mrf_stage.mrf_stage(torch.zeros((1, 64, 48), device=cuda),
                            torch.zeros((2 * 48 * 48 * 63,), device=cuda),
                            torch.zeros((18, 48), device=cuda), RK, RD)


def _k1_bf16_args(args):
    """fp32 stack inputs -> the bf16 route's: bf16 activations and weights,
    fp32 biases."""
    x0, cond, step, wd, bd, wo, bo = args
    b16 = torch.bfloat16
    return (x0.to(b16), cond.to(b16), step.to(b16), wd.to(b16), bd, wo.to(b16), bo)


# (4, 256), the path's shape, and (2, 100) take the bf16 kernel's narrow
# path, 16-frame tiles over clusters of two; (32, 1024), the bench's shape,
# and (4, 1100), 36 tiles with a ragged last one, its wide path, 128-frame
# tiles on wgmma
@pytest.mark.parametrize("B,T", [(4, 256), (2, 100), (32, 1024), (4, 1100)])
def test_residual_stack_bf16_kernel_matches_plain(cuda, B, T):
    C, L = 256, 20
    dils = [2 ** (i % 4) for i in range(L)]
    g = torch.Generator(device=cuda).manual_seed(B * T + 1)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    args = _k1_bf16_args((torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
                          r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
                          r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1)))
    before = diffnet_stack.counter_bf16.launches
    got = diffnet_stack.residual_stack_bf16(*args, dils)
    torch.cuda.synchronize()
    assert diffnet_stack.counter_bf16.launches == before + 1
    assert got.dtype == torch.float32
    ref = diffnet_stack.residual_stack_plain_bf16(*args, dils)
    assert _rel(got, ref) <= diffnet_stack.TOLERANCE_BF16
    assert _mean_rel(got, ref) <= diffnet_stack.MEAN_TOLERANCE_BF16


@pytest.mark.parametrize("B,U,F", [(2, 2048 + 37, 256), (2, 2048 + 37, 128), (2, 2048 + 37, 64),
                                   (2, 2048 + 37, 32), (4, 2048, 256), (4, 8192, 128),
                                   (4, 16384, 64), (4, 32768, 32)])
def test_mrf_stage_bf16_kernel_matches_plain(cuda, B, U, F):
    g = torch.Generator(device=cuda).manual_seed(F + 1)
    x = torch.randn((B, U, F), generator=g, device=cuda)
    n_w = 2 * F * F * sum(k * len(d) for k, d in zip(RK, RD))
    w = (torch.randn((n_w,), generator=g, device=cuda) * (7 * F) ** -0.5).to(torch.bfloat16)
    b = 0.1 * torch.randn((18, F), generator=g, device=cuda)
    before = mrf_stage.counter_bf16.launches
    got = mrf_stage.mrf_stage_bf16(x, w, b, RK, RD)
    torch.cuda.synchronize()
    assert mrf_stage.counter_bf16.launches == before + 1
    ref = mrf_stage.mrf_stage_plain_bf16(x, w, b, RK, RD)
    assert _rel(got, ref) <= mrf_stage.TOLERANCE_BF16
    assert _mean_rel(got, ref) <= mrf_stage.MEAN_TOLERANCE_BF16


# Back-to-back launches on the same inputs give the same bits: a race in a
# kernel's pipeline (a K2 ring on mbarriers deadlocked within 50 to 200
# launches) shows here before it shows on the path.
@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_bf16_kernels_repeat_bit_identically(cuda, kernel):
    g = torch.Generator(device=cuda).manual_seed(7)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    if kernel == "k1":
        C, L, B, T = 256, 20, 4, 256
        args = _k1_bf16_args((torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
                              r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
                              r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1)))
        dils = [2 ** (i % 4) for i in range(L)]
        run = lambda: diffnet_stack.residual_stack_bf16(*args, dils)  # noqa: E731
    else:
        F = 256
        n_w = 2 * F * F * sum(k * len(d) for k, d in zip(RK, RD))
        x, b = r(2, 2048 + 37, F), r(18, F, sc=0.1)
        w = r(n_w, sc=(7 * F) ** -0.5).to(torch.bfloat16)
        run = lambda: mrf_stage.mrf_stage_bf16(x, w, b, RK, RD)  # noqa: E731
    first = run()
    outs = [run() for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


# The bf16 kernels launched back to back, 2000 times after a first launch for
# each case (K1-bf16's wide path at B=32, T=1024 and narrow at B=4, T=256;
# K2-bf16's F=256 stage at both batches), with only the C entry point's
# cudaGetLastError between launches, in a child process that is killed after
# 180 s: a hang fails here instead of hanging the run; the last output
# equals the first, bit for bit.
def test_bf16_kernels_end_back_to_back_within_a_limit(cuda):
    from bisinger_tpu_torch.tools import repeat_launch

    ok, results, msg = repeat_launch.run(2000, 180.0)
    assert ok, msg
    assert [(r["kernel"], r["B"], r["T"], r["width"]) for r in results] == \
        list(repeat_launch.CASES)
    assert all(r["launches"] == 2001 and r["bit_identical"] for r in results)


# K1-bf16 at ragged shapes, each path: B=1, T=32 (narrow); T=1000, a multiple
# of neither tile (16 and 128 frames), narrow at B=3 (24 128-frame tiles)
# and wide at B=33 (264), the wide one also with dilations other than the
# flagship's (dmax 9); the bench's B=32, T=1024; and the write-last mode at
# a pipeline stage's 4 layers with the flagship's dilations, on both paths
@pytest.mark.parametrize("B,T,L,dils,write_last", [
    (1, 32, 20, None, False), (3, 1000, 20, None, False), (33, 1000, 20, None, False),
    (33, 1000, 20, [1, 3, 5, 7, 9] * 4, False), (32, 1024, 20, None, False),
    (4, 256, 4, None, True), (32, 1024, 4, None, True)])
def test_bf16_residual_stack_at_ragged_shapes(cuda, B, T, L, dils, write_last):
    dils = dils or [2 ** (i % 4) for i in range(L)]
    g = torch.Generator(device=cuda).manual_seed(B + T + L)
    args = _k1_bf16_args(_k1_fp32_args(g, B, T, L))
    got = diffnet_stack.residual_stack_bf16(*args, dils, write_last=write_last)
    torch.cuda.synchronize()
    ref = diffnet_stack.residual_stack_plain_bf16(*args, dils, write_last=write_last)
    pairs = zip(got, ref) if write_last else [(got, ref)]
    for out, want in pairs:
        out, want = out.float(), want.float()
        assert _rel(out, want) <= diffnet_stack.TOLERANCE_BF16
        assert _mean_rel(out, want) <= diffnet_stack.mean_tolerance_bf16(L)


# K2-bf16 at ragged shapes on its cluster layouts (F=256 and F=128): B=1
# and B=3 with U a multiple of no chunk, B=32 at the bench's F=256 stage
# less a few samples, and kernels and dilations other than the flagship's
@pytest.mark.parametrize("B,U,F,rk,rd", [
    (1, 1013, 256, RK, RD), (3, 4099, 256, RK, RD), (32, 8 * 1024 - 5, 256, RK, RD),
    (1, 1013, 128, RK, RD), (3, 4099 * 4, 128, RK, RD), (2, 1500, 128, [3, 5], [[1, 2], [2, 4]]),
    (2, 1500, 256, [5, 9], [[2, 1, 3], [1, 4, 2]])])
def test_bf16_mrf_stage_at_ragged_shapes(cuda, B, U, F, rk, rd):
    g = torch.Generator(device=cuda).manual_seed(B + U + F + 1)
    x, w, b = _k2_fp32_args(g, B, U, F, rk, rd)
    w = w.to(torch.bfloat16)
    got = mrf_stage.mrf_stage_bf16(x, w, b, rk, rd)
    torch.cuda.synchronize()
    ref = mrf_stage.mrf_stage_plain_bf16(x, w, b, rk, rd)
    assert _rel(got, ref) <= mrf_stage.TOLERANCE_BF16
    assert _mean_rel(got, ref) <= mrf_stage.MEAN_TOLERANCE_BF16


# K1's write-last mode, both routes: the skip and the state after the last
# layer against the plain versions, at a pipeline stage of the flagship
# (B=4, T=256, 4 layers) and at a seq rank's widened chunk (B=1, T=2048 + 75,
# 20 layers); the skip is the default call's, bit for bit, and the flag off
# is the default call.
@pytest.mark.parametrize("route", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,L", [(4, 256, 4), (1, 2048 + 75, 20)])
def test_residual_stack_write_last_matches_plain(cuda, route, B, T, L):
    C = 256
    dils = [2 ** (i % 4) for i in range(L)]
    g = torch.Generator(device=cuda).manual_seed(B * T + L)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    args = (torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
            r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
            r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1))
    if route == "bf16":
        args = _k1_bf16_args(args)
        fn, plain = diffnet_stack.residual_stack_bf16, diffnet_stack.residual_stack_plain_bf16
        tol, counter = diffnet_stack.TOLERANCE_BF16, diffnet_stack.counter_bf16
    else:
        fn, plain = diffnet_stack.residual_stack, diffnet_stack.residual_stack_plain
        tol, counter = diffnet_stack.TOLERANCE, diffnet_stack.counter
    before = counter.launches
    skip, x_last = fn(*args, dils, write_last=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and (B, T, C, tuple(dils)) in counter.shapes
    ref_skip, ref_x = plain(*args, dils, write_last=True)
    assert x_last.dtype == ref_x.dtype == args[0].dtype and x_last.shape == (B, T, C)
    for got, ref in ((skip, ref_skip), (x_last.float(), ref_x.float())):
        assert _rel(got, ref) <= tol
        if route == "bf16":
            assert _mean_rel(got, ref) <= diffnet_stack.mean_tolerance_bf16(L)
    default = fn(*args, dils)
    assert torch.equal(fn(*args, dils, write_last=False), default)
    assert torch.equal(skip, default)


def test_bf16_wrappers_reject_what_the_kernels_do_not_take(cuda):
    b16 = torch.bfloat16
    x = torch.zeros((1, 64, 256), device=cuda)
    w = torch.zeros((2 * 256 * 256 * 63,), device=cuda, dtype=b16)
    b = torch.zeros((18, 256), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):  # fp32 weights on the bf16 route
        mrf_stage.mrf_stage_bf16(x, w.float(), b, RK, RD)
    with pytest.raises(ValueError, match="shape"):
        mrf_stage.mrf_stage_bf16(x, w[:-1].contiguous(), b, RK, RD)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_stage.mrf_stage_bf16(torch.zeros((1, 256, 64), device=cuda).transpose(1, 2), w, b,
                                 RK, RD)
    C, L, B, T = 256, 2, 2, 16
    args = [torch.zeros(s, device=cuda, dtype=dt) for s, dt in (
        ((B, T, C), b16), ((L, B, T, 2 * C), b16), ((L, B, C), b16), ((L, 3, C, 2 * C), b16),
        ((L, 2 * C), torch.float32), ((L, C, 2 * C), b16), ((L, 2 * C), torch.float32))]
    diffnet_stack.residual_stack_bf16(*args, [1, 2])  # the valid call launches
    bad_dtype = list(args)
    bad_dtype[1] = args[1].float()  # cond_proj in fp32
    with pytest.raises(ValueError, match="bfloat16"):
        diffnet_stack.residual_stack_bf16(*bad_dtype, [1, 2])
    bad_shape = list(args)
    bad_shape[2] = args[2][:, :, :-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        diffnet_stack.residual_stack_bf16(*bad_shape, [1, 2])
    with pytest.raises(ValueError, match="contiguous"):
        diffnet_stack.residual_stack_bf16(
            args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:], [1, 2])


# The kernel build is shared by threads (the server's handler threads can
# reach a kernel first together): two threads loading one library into an
# empty build directory run nvcc once and get the same library.
def test_first_build_from_two_threads_runs_nvcc_once(cuda, tmp_path, monkeypatch):
    import threading

    from bisinger_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_loaded", {})
    runs, real_popen = [], _build.subprocess.Popen
    monkeypatch.setattr(_build.subprocess, "Popen",
                        lambda cmd, **kw: runs.append(cmd) or real_popen(cmd, **kw))
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(_build.load("mrf_stage", 256)))
               for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(runs) == 1 and len(libs) == 2 and libs[0] is libs[1]


# The score entry points run inference on threads that did not enter
# no_grad (the micro-batcher's worker, the serial path's handler threads);
# infer_batch sets it itself, and the kernels count their launches there.
def test_infer_batch_on_a_worker_thread(cuda):
    import threading

    import numpy as np

    from bisinger_tpu_torch.inference.pipeline import SVSInferTorch

    svs = SVSInferTorch.from_checkpoint(device=cuda, hp_overrides="K_step=20,pndm_speedup=5")
    score = dict(text="SP wo ai ni", notes="rest | C4 | D4 | E4",
                 notes_duration="0.1 | 0.3 | 0.3 | 0.4")
    diffnet_stack.counter_bf16.launches = 0
    out = {}
    th = threading.Thread(target=lambda: out.update(wav=svs.infer_once(score),
                                                    grad=torch.is_grad_enabled()))
    th.start()
    th.join()
    torch.cuda.synchronize()
    assert out["grad"] and np.isfinite(out["wav"]).all() and len(out["wav"]) % 128 == 0
    assert diffnet_stack.counter_bf16.launches == 20 // 5 + 1
    assert np.array_equal(out["wav"], svs.infer_once(score))


@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_kernels_refuse_autograd_on_the_card(cuda, route):
    """K1 and K2 on CUDA tensors: an input that requires grad under grad mode
    raises before any launch; under no_grad the kernel launches. No train
    step of the PitchExtractor or the GAN vocoder launches either."""
    b16 = route == "bf16"
    g = torch.Generator(device=cuda).manual_seed(0)
    B, T, C, L = 1, 64, 256, 2
    args = [torch.randn(s, generator=g, device=cuda) * 0.1
            for s in ((B, T, C), (L, B, T, 2 * C), (L, B, C), (L, 3, C, 2 * C), (L, 2 * C),
                      (L, C, 2 * C), (L, 2 * C))]
    k1 = diffnet_stack.residual_stack_bf16 if b16 else diffnet_stack.residual_stack
    counter = diffnet_stack.counter_bf16 if b16 else diffnet_stack.counter
    if b16:
        args = list(_k1_bf16_args(args))
    args[3] = args[3].clone().requires_grad_(True)
    counter.launches = 0
    with pytest.raises(RuntimeError, match="requires grad"):
        k1(*args, [1, 2])
    assert counter.launches == 0
    with torch.no_grad():
        assert k1(*args, [1, 2]).shape == (B, T, C)
    assert counter.launches == 1
    F = 64
    x = torch.randn((1, 256, F), generator=g, device=cuda).requires_grad_(True)
    w = torch.randn((2 * F * F * 63,), generator=g, device=cuda) * 0.01
    b = torch.zeros((18, F), device=cuda)
    k2 = mrf_stage.mrf_stage_bf16 if b16 else mrf_stage.mrf_stage
    w = w.to(torch.bfloat16) if b16 else w
    with pytest.raises(RuntimeError, match="requires grad"):
        k2(x, w, b, RK, RD)
    with torch.no_grad():
        assert k2(x, w, b, RK, RD).shape == x.shape
    # a train step of the PitchExtractor and of the GAN vocoder (full band and
    # mb4) in this route's compute_dtype launches neither kernel
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.training.tasks import PitchExtractionTask
    from bisinger_tpu_torch.training.vocoder_task import HifiGanTask

    dt = "bfloat16" if b16 else "float32"
    counters = (diffnet_stack.counter, diffnet_stack.counter_bf16, mrf_stage.counter,
                mrf_stage.counter_bf16)
    for c in counters:
        c.launches = 0
    pe = PitchExtractionTask(make_hparams(dict(compute_dtype=dt)), device=cuda)
    pe.train_step({"mels": torch.randn(2, 64, 80, device=cuda) - 3,
                   "mel2ph": torch.ones(2, 64, dtype=torch.long, device=cuda),
                   "f0": torch.full((2, 64), 7.5, device=cuda),
                   "uv": torch.zeros(2, 64, device=cuda)}, torch.Generator(device=cuda))
    for over in ({}, dict(vocoder_multiband=4, upsample_rates=[8, 4],
                          upsample_kernel_sizes=[16, 8])):
        voc = HifiGanTask(make_hparams(dict(compute_dtype=dt, **over)), device=cuda)
        voc.train_step({"mels": torch.randn(2, 32, 80, device=cuda),
                        "f0": torch.full((2, 32), 220.0, device=cuda),
                        "wav": 0.1 * torch.randn(2, 32 * 128, device=cuda)},
                       torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert all(c.launches == 0 for c in counters)


def _k1_fp32_args(g, B, T, L, C=256):
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=g.device)  # noqa: E731
    return (torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
            r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
            r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1))


def _k2_fp32_args(g, B, U, F, rk=RK, rd=RD):
    x = torch.randn((B, U, F), generator=g, device=g.device)
    n_w = 2 * F * F * sum(k * len(d) for k, d in zip(rk, rd))
    w = torch.randn((n_w,), generator=g, device=g.device) * (7 * F) ** -0.5
    b = 0.1 * torch.randn((2 * sum(len(d) for d in rd), F), generator=g, device=g.device)
    return x, w, b


K1_WIDTHS = tuple(range(32, 513, 32))
K2_WIDTHS = (8, 16, 32, 64, 128, 256, 512)


# Every width K1 is built for (ops/_build.py K1_WIDTHS), both routes, with a
# ragged last tile each time: (2, 100) the narrow tiles (16 to 64 frames by
# width); (4, 1100), 36 tiles of 128 frames, the bf16 wide path where C % 64
# == 0 (128-frame tiles to C = 256, 64-frame ones above); (9, 1000), 144
# tiles of 64 frames, the fp32 route's 64-frame tiles at C = 128 and 256
@pytest.mark.parametrize("C", K1_WIDTHS)
@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_residual_stack_at_every_width(cuda, route, C):
    L = 20
    dils = [2 ** (i % 4) for i in range(L)]
    counter = diffnet_stack.counter_bf16 if route == "bf16" else diffnet_stack.counter
    for B, T in ((2, 100), (4, 1100), (9, 1000)):
        g = torch.Generator(device=cuda).manual_seed(B + T + C)
        args = _k1_fp32_args(g, B, T, L, C)
        before = counter.launches
        if route == "bf16":
            args = _k1_bf16_args(args)
            got = diffnet_stack.residual_stack_bf16(*args, dils)
            ref = diffnet_stack.residual_stack_plain_bf16(*args, dils)
        else:
            got = diffnet_stack.residual_stack(*args, dils)
            ref = diffnet_stack.residual_stack_plain(*args, dils)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        if route == "bf16":
            assert _rel(got, ref) <= diffnet_stack.TOLERANCE_BF16, (B, T)
            assert _mean_rel(got, ref) <= diffnet_stack.MEAN_TOLERANCE_BF16, (B, T)
        else:
            assert _rel(got, ref) <= diffnet_stack.TOLERANCE, (B, T)


# Every width K2 is built for, both routes: B=2 with a ragged last chunk, the
# stage's shape at B=4, T=256 in the generator where it stands (F = 512 to 64
# after upsample_initial_channel 1024, 64 to 8 after 128; rates 8, 4, 2, 2),
# and two blocks of other kernels and dilations
K2_STAGE_U = {512: 2048, 256: 2048, 128: 8192, 64: 16384, 32: 32768, 16: 16384, 8: 32768}


@pytest.mark.parametrize("F", K2_WIDTHS)
@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_mrf_stage_at_every_width(cuda, route, F):
    counter = mrf_stage.counter_bf16 if route == "bf16" else mrf_stage.counter
    for B, U, rk, rd in ((2, 2048 + 37, RK, RD), (4, K2_STAGE_U[F], RK, RD),
                         (2, 1500, [3, 5], [[1, 2], [2, 4]])):
        g = torch.Generator(device=cuda).manual_seed(B + U + F)
        x, w, b = _k2_fp32_args(g, B, U, F, rk, rd)
        before = counter.launches
        if route == "bf16":
            w = w.to(torch.bfloat16)
            got = mrf_stage.mrf_stage_bf16(x, w, b, rk, rd)
            ref = mrf_stage.mrf_stage_plain_bf16(x, w, b, rk, rd)
        else:
            got = mrf_stage.mrf_stage(x, w, b, rk, rd)
            ref = mrf_stage.mrf_stage_plain(x, w, b, rk, rd)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        if route == "bf16":
            assert _rel(got, ref) <= mrf_stage.TOLERANCE_BF16, (B, U)
            assert _mean_rel(got, ref) <= mrf_stage.mean_tolerance_bf16(F), (B, U)
        else:
            assert _rel(got, ref) <= mrf_stage.TOLERANCE, (B, U)


# The fp32 routes where their tiles do not divide the input: K1 with B=1 and
# T ragged on its 16-frame tiles, T ragged on its 64-frame tiles (B=32), and
# a dilation list other than the flagship's (dmax 9, L=10); K2 with B=1 at
# every stage width, U not a multiple of any chunk at F=256, and kernels and
# dilations other than the flagship's
@pytest.mark.parametrize("B,T,dils", [(1, 77, None), (32, 1000, None),
                                      (3, 300, [1, 3, 5, 7, 9] * 2)])
def test_fp32_residual_stack_at_ragged_shapes(cuda, B, T, dils):
    dils = dils or [2 ** (i % 4) for i in range(20)]
    g = torch.Generator(device=cuda).manual_seed(B + T)
    args = _k1_fp32_args(g, B, T, len(dils))
    got = diffnet_stack.residual_stack(*args, dils)
    torch.cuda.synchronize()
    assert _rel(got, diffnet_stack.residual_stack_plain(*args, dils)) <= diffnet_stack.TOLERANCE


@pytest.mark.parametrize("B,U,F,rk,rd", [
    (1, 1013, 32, RK, RD), (1, 1013, 64, RK, RD), (1, 1013, 128, RK, RD), (1, 1013, 256, RK, RD),
    (3, 4099, 256, RK, RD), (2, 1500, 128, [3, 5], [[1, 2], [2, 4]]),
    (2, 1500, 256, [5, 9], [[2, 1, 3], [1, 4, 2]])])
def test_fp32_mrf_stage_at_ragged_shapes(cuda, B, U, F, rk, rd):
    g = torch.Generator(device=cuda).manual_seed(B + U + F)
    x, w, b = _k2_fp32_args(g, B, U, F, rk, rd)
    got = mrf_stage.mrf_stage(x, w, b, rk, rd)
    torch.cuda.synchronize()
    assert _rel(got, mrf_stage.mrf_stage_plain(x, w, b, rk, rd)) <= mrf_stage.TOLERANCE


# The fp32 routes at least 10x under their plain versions with single-pass
# TF32 products: a kernel that skipped the split of an operand would read
# near the control.
@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_fp32_kernels_sit_under_the_single_pass_control(cuda, kernel):
    g = torch.Generator(device=cuda).manual_seed(11)
    if kernel == "k1":
        dils = [2 ** (i % 4) for i in range(20)]
        args = _k1_fp32_args(g, 4, 256, 20)
        got = diffnet_stack.residual_stack(*args, dils)
        ref = diffnet_stack.residual_stack_plain(*args, dils)
        control = _tf32.residual_stack_plain_tf32(*args, dils, passes=1)
    else:
        x, w, b = _k2_fp32_args(g, 2, 2048 + 37, 256)
        got = mrf_stage.mrf_stage(x, w, b, RK, RD)
        ref = mrf_stage.mrf_stage_plain(x, w, b, RK, RD)
        control = _tf32.mrf_stage_plain_tf32(x, w, b, RK, RD, passes=1)
    torch.cuda.synchronize()
    assert 10 * _rel(got, ref) <= _rel(control, ref)


# The fp32 routes' cp.async rings, like the bf16 routes': back-to-back
# launches on the same inputs give the same bits.
@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_fp32_kernels_repeat_bit_identically(cuda, kernel):
    g = torch.Generator(device=cuda).manual_seed(7)
    if kernel == "k1":
        dils = [2 ** (i % 4) for i in range(20)]
        args = _k1_fp32_args(g, 4, 256, 20)
        run = lambda: diffnet_stack.residual_stack(*args, dils)  # noqa: E731
    else:
        x, w, b = _k2_fp32_args(g, 2, 2048 + 37, 256)
        run = lambda: mrf_stage.mrf_stage(x, w, b, RK, RD)  # noqa: E731
    first = run()
    outs = [run() for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


# The multiband (mb4) vocoder's stages: F=256 over 8T and F=128 over 32T
# samples (upsample rates [8, 4]), at the serving batch of chip_smoke.py
# phase 11 (B=4, T=512) and ragged
@pytest.mark.parametrize("B,U,F", [(4, 8 * 512, 256), (4, 32 * 512, 128), (1, 8 * 37, 256),
                                   (1, 32 * 37, 128)])
@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_mrf_stage_at_the_mb4_stage_shapes(cuda, route, B, U, F):
    _stage_matches_plain(cuda, route, B, U, F)


def _stage_matches_plain(cuda, route, B, U, F):
    g = torch.Generator(device=cuda).manual_seed(B + U + F)
    x, w, b = _k2_fp32_args(g, B, U, F)
    if route == "fp32":
        got = mrf_stage.mrf_stage(x, w, b, RK, RD)
        torch.cuda.synchronize()
        assert _rel(got, mrf_stage.mrf_stage_plain(x, w, b, RK, RD)) <= mrf_stage.TOLERANCE
    else:
        w = w.to(torch.bfloat16)
        got = mrf_stage.mrf_stage_bf16(x, w, b, RK, RD)
        torch.cuda.synchronize()
        ref = mrf_stage.mrf_stage_plain_bf16(x, w, b, RK, RD)
        assert _rel(got, ref) <= mrf_stage.TOLERANCE_BF16
        assert _mean_rel(got, ref) <= mrf_stage.MEAN_TOLERANCE_BF16


# The plain HiFi-GAN's stages (configs/tts/hifigan.yaml: rates 8·8·2·2, 512
# channels): F=256, 128, 64 and 32 over 8T, 64T, 128T and 256T samples at the
# TTS request of chip_smoke.py phase 13 (B=1, T=512), and ragged
@pytest.mark.parametrize("B,U,F", [(1, 8 * 512, 256), (1, 64 * 512, 128), (1, 128 * 512, 64),
                                   (1, 256 * 512, 32), (2, 8 * 37, 256), (2, 256 * 37, 32)])
@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_mrf_stage_at_the_tts_stage_shapes(cuda, route, B, U, F):
    _stage_matches_plain(cuda, route, B, U, F)


def _tts_path(device):
    """DiffSpeech from configs/usr/lj_ds_beta6.yaml in fp32 (hidden 256, the
    CWT head, DiffNet 20 x 256, T=100, K=71, PLMS at pndm_speedup 5) and the
    plain generator of configs/tts/hifigan.yaml (512 channels), seeded draws
    (the duration head's bias at 1.6, so that every phone gets frames; the
    CWT stats head's at a log-f0 mean of 5.3, 200 Hz; the generator's
    upsamplers and conv_post at unit gain, so that the waveform carries the
    stages' signal), on `device`."""
    from bisinger_tpu_torch.config import load_hparams
    from bisinger_tpu_torch.inference.pipeline import SVSInferTorch
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
    from bisinger_tpu_torch.training.tasks import flax_init_
    from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder

    phones = ["<SP>", "AA1", "AE1", "D", "K", "L", "M", "N", "T"]
    hp = load_hparams("usr/lj_ds_beta6.yaml", dict(compute_dtype="float32", bucket_tokens=[16],
                                                   bucket_frames=[64]))
    voc_hp = load_hparams("tts/hifigan.yaml", dict(compute_dtype="float32"))
    model = flax_init_(GaussianDiffusion(hp, len(phones) + 3), 0)
    g = torch.Generator().manual_seed(1)
    vocoder = HifiGanGenerator(voc_hp)
    with torch.no_grad():
        model.fs2.dur_predictor.linear.bias.fill_(1.6)
        model.fs2.cwt_stats_2.bias.copy_(torch.tensor([5.3, 0.25]))  # log-f0 ~ 200 Hz
        model.denoise_fn.output_projection.weight.normal_(0, 0.05, generator=g)
        for name, p in vocoder.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.randn(p.shape, generator=g) * (
                0.03 if name.startswith("res_") else fan_in ** -0.5) if p.dim() > 1
                else 0.05 * torch.randn(p.shape, generator=g))
    return SVSInferTorch(hp, model, None, vocoder, device,
                         encoder=TokenTextEncoder(phones, replace_oov=","),
                         spk_map={"LJSpeech": 0})


def test_tts_path_on_the_card_matches_the_cpu(cuda):
    """The TTS path in fp32, card (K1 and K2, fp32 routes) against CPU
    (their plain versions) from a phoneme-level request, the start noise
    pinned: durations from the predictor, f0 from the CWT head, PLMS over
    K=71 (2 + len(arange(0, 71, 5)) - 1 = 16 K1 launches), the plain
    generator (4 K2 launches); the port's parity bounds: mel 1e-3, f0 1 Hz,
    waveform 2e-3."""
    import numpy as np

    req = dict(input_type="phoneme", ph_seq="<SP> K AE1 T <SP> M AA1 D <SP>",
               note_seq=" ".join(["rest"] * 9), note_dur_seq=" ".join(["0.06"] * 9),
               is_slur_seq=" ".join(["0"] * 9), lang_seq=" ".join(["0"] * 9))
    on_card, on_cpu = _tts_path(cuda), _tts_path(torch.device("cpu"))
    batch = on_cpu.items_to_batch(on_cpu.score_items([req]))
    start = torch.randn((1, batch["n_frames"], 80), generator=torch.Generator().manual_seed(2))
    counters = (diffnet_stack.counter, diffnet_stack.counter_bf16, mrf_stage.counter,
                mrf_stage.counter_bf16)
    for c in counters:
        c.launches = 0
    got = on_card.synthesize(batch, start_noise=start.to(cuda))
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [2 + len(np.arange(0, 71, 5)) - 1, 0, 4, 0]
    ref = on_cpu.synthesize(batch, start_noise=start)
    assert torch.equal(got["mel2ph"].cpu(), ref["mel2ph"]) and int((ref["mel2ph"] > 0).sum()) >= 9
    assert (got["mel"].cpu() - ref["mel"]).abs().max() <= 1e-3
    assert (got["f0"].cpu() - ref["f0"]).abs().max() <= 1.0 and ref["f0"].max() > 50
    assert ref["wav"].std() > 1e-2 and (got["wav"].cpu() - ref["wav"]).abs().max() <= 2e-3


@pytest.mark.parametrize("variant", ["full_band", "mb4"])
def test_fp32_gan_step_on_the_card_matches_the_cpu(cuda, variant):
    """One fp32 GAN step (64 channels, B=2, 32 frames, voiced f0) from the
    same initialisation and NSF draw on the card and on the CPU, with the
    CPU test's bounds (tools/step_parity: every loss 1e-5 of its own value,
    every gradient of both updates within 1e-4 of its update's largest,
    every parameter within 1e-6 beyond what the gradients' difference moves
    through Adam's first step)."""
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.tools.step_parity import gan_step_parity

    over = dict(compute_dtype="float32", upsample_initial_channel=64)
    if variant == "mb4":
        over.update(vocoder_multiband=4, upsample_rates=[8, 4], upsample_kernel_sizes=[16, 8])
    ok, text = gan_step_parity(make_hparams(over), cuda)
    assert ok, text


def _popcs_batch(b=2, n_tokens=16, n_frames=64, seed=0):
    """A PopCS-shaped numpy batch: tokens, a sorted frame map, the target mel,
    log2 f0 with uv, energy, word boundaries and a recorded fs2 mel."""
    import numpy as np

    r = np.random.default_rng(seed)
    txt = np.zeros((b, n_tokens), np.int64)
    txt[:, : n_tokens - 2] = r.integers(3, 14, (b, n_tokens - 2))
    mel2ph = np.zeros((b, n_frames), np.int64)
    mel2ph[:, : n_frames - 8] = np.sort(r.integers(1, n_tokens - 2, (b, n_frames - 8)), axis=1)
    mels = (r.standard_normal((b, n_frames, 80)) * 0.5 - 4).astype(np.float32)
    mels[mel2ph == 0] = 0.0
    uv = (r.random((b, n_frames)) < 0.3).astype(np.float32)
    return dict(txt_tokens=txt, mel2ph=mel2ph, spk_ids=np.zeros((b,), np.int64), mels=mels,
                f0=r.uniform(7.3, 8.6, (b, n_frames)).astype(np.float32), uv=uv,
                energy=np.sqrt((np.exp(mels) ** 2).sum(-1)).astype(np.float32),
                word_boundary=r.integers(0, 2, (b, n_tokens)),
                fs2_mels=mels + (0.3 * r.standard_normal(mels.shape)).astype(np.float32))


@pytest.mark.parametrize("task", ["FastSpeech2Task", "DiffSingerOfflineTask"])
def test_fp32_popcs_step_on_the_card_matches_the_cpu(cuda, task):
    """One fp32 step of the PopCS configs' tasks (hidden 256 from the YAML
    configs; FastSpeech2Task with frame pitch, uv and energy on) from the
    same initialisation on the card and on the CPU, at chip_smoke phase 12's
    bounds (tools/step_parity: every loss within 1e-5 of its value, every
    gradient within 1e-4 of the largest, every parameter within 1e-6 beyond
    Adam's carry, ReLU kinks pinned to the CPU's side)."""
    import numpy as np

    from bisinger_tpu_torch.config import load_hparams
    from bisinger_tpu_torch.tools.step_parity import step_parity
    from bisinger_tpu_torch.training import tasks

    cfg = {"FastSpeech2Task": "usr/popcs_fs2.yaml",
           "DiffSingerOfflineTask": "usr/popcs_ds_beta6_offline.yaml"}[task]
    hp = load_hparams(cfg, dict(compute_dtype="float32", dropout=0.0, predictor_dropout=0.0,
                                use_energy_embed=True))
    cls = getattr(tasks, task)
    params = cls(hp, 16, device="cpu").state()["params"]
    for k in params:  # the DiffNet's zero-initialised output projection, drawn
        if k.startswith("denoise_fn/output_projection/"):
            params[k] = 0.05 * np.random.default_rng(1).standard_normal(
                params[k].shape).astype(np.float32)
    g = torch.Generator().manual_seed(2)
    pins = {} if task == "FastSpeech2Task" else dict(
        t=torch.randint(0, hp["K_step"], (2,), generator=g), noise=torch.randn((2, 64, 80),
                                                                                generator=g))
    ok, text = step_parity(lambda d: cls(hp, 16, device=d), params, _popcs_batch(), pins, cuda)
    assert ok, text


def test_popcs_bf16_synthesis_launches_k1_and_k2(cuda):
    """popcs_ds_beta6 (bf16, K=51, PLMS at pndm_speedup 1) with the
    flagship's vocoder and no PE, from a phoneme-level score: K1-bf16 once
    a denoiser call (K/speedup + 1 = 52), K2-bf16 once an MRF stage (4), no
    fp32 launch; finite audio, frames x 128 samples."""
    import numpy as np

    from bisinger_tpu_torch.config import load_hparams, load_hparams_json
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, _pe_and_vocoder
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.training.tasks import flax_init_
    from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder

    phones = ["<SP>", "a", "ang", "ao", "h", "i", "in", "l", "m", "sh", "x"]
    hp = load_hparams("usr/popcs_ds_beta6.yaml")
    assert hp["compute_dtype"] == "bfloat16" and hp["K_step"] == 51 and hp["pndm_speedup"] == 1
    model = flax_init_(GaussianDiffusion(hp, len(phones) + 3), 0)
    _, vocoder = _pe_and_vocoder(FLAGSHIP_DIR, load_hparams_json(
        f"{FLAGSHIP_DIR}/hparams_diff.json"), with_pe=False)
    svs = SVSInferTorch(hp, model, None, vocoder, cuda,
                        encoder=TokenTextEncoder(phones, replace_oov=","), spk_map={"pop-cs": 0})
    score = dict(input_type="phoneme", ph_seq="<SP> sh ang x in h ao <SP>",
                 note_seq="rest C4 C4 D4 D4 E4 E4 rest", note_dur_seq="0.1 " * 7 + "0.1",
                 is_slur_seq=" ".join(["0"] * 8), lang_seq=" ".join(["1"] * 8))
    counters = (diffnet_stack.counter, diffnet_stack.counter_bf16, mrf_stage.counter,
                mrf_stage.counter_bf16)
    for c in counters:
        c.launches = 0
    wav = svs.infer_once(score)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [0, 52, 0, 4]
    assert np.isfinite(wav).all() and len(wav) % 128 == 0 and len(wav) > 0


_DP_PROBE = """
import sys
import torch
import torch.distributed as dist
from bisinger_tpu_torch.parallel import mesh as dp
try:
    dev = dp.init_data_parallel("cuda:0", sys.argv[1], sys.argv[2])
except RuntimeError as e:
    print("REFUSED", e)
    sys.exit(3)
t = torch.full((3,), float(dp.rank() + 1), device=dev)
dist.all_reduce(t)
torch.cuda.synchronize()
print("SUM", t.tolist(), dist.get_backend())
dp.shutdown()
"""


def test_nccl_group_at_world_size_one_and_on_a_shared_card(cuda, tmp_path):
    """Data parallelism over NCCL on the card: a group of one rank forms on
    cuda:0 and all-reduces there; two ranks that ask NCCL for the one card
    both raise before any NCCL call, naming the device, and leave; gloo
    lets them share it."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def ranks(world, backend, tag):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _DP_PROBE, backend, f"file://{tmp_path / tag}"],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     PYTHONPATH=repo), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        return [(p.communicate(timeout=300)[0], p.returncode) for p in procs]

    ((out, rc),) = ranks(1, "nccl", "one")
    assert rc == 0 and "SUM [1.0, 1.0, 1.0]" in out and "nccl" in out, out[-2000:]
    for out, rc in ranks(2, "nccl", "shared"):
        assert rc == 3 and "share the device cuda:0" in out, out[-2000:]
    for out, rc in ranks(2, "gloo", "gloo"):
        assert rc == 0 and "SUM [3.0, 3.0, 3.0]" in out, out[-2000:]


# dataloader_prefetch_put: worker on the card: each batch copied on the
# prefetch thread from pinned memory on a side stream, the step's stream
# waiting on its event, equals the main thread's copy bit for bit
def test_prefetch_put_worker_on_the_card(cuda):
    import numpy as np

    from bisinger_tpu_torch.data.dataset import batch_to_device
    from bisinger_tpu_torch.data.prefetch import DevicePut, Prefetcher

    r = np.random.RandomState(0)
    raw = [dict(txt_tokens=r.randint(1, 50, (8, 64)), mels=r.randn(8, 512, 80).astype(np.float32),
                f0=r.rand(8, 512).astype(np.float32)) for _ in range(6)]
    put = DevicePut(cuda)
    assert put.stream is not None
    pf = Prefetcher(iter(raw), depth=2, transform=put.stage)
    got = [put.take(staged) for staged in pf]
    want = [batch_to_device(b, cuda) for b in raw]
    torch.cuda.synchronize()
    assert len(got) == len(raw)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert all(a[k].device == b[k].device and torch.equal(a[k], b[k]) for k in a)
