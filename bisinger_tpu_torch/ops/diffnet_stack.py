"""K1: the DiffNet residual stack (counterpart of
`bisinger_tpu/ops/diffnet_pallas.py:fused_residual_stack`, line 174).

Two routes, chosen by the model's `compute_dtype`:
- fp32: `residual_stack` runs `csrc/diffnet_stack.cu` (TF32 tensor cores
  in 3xTF32, to fp32 accuracy; `_tf32.py` models the arithmetic);
- bf16: `residual_stack_bf16` runs `csrc/diffnet_stack_bf16.cu` (tensor
  cores), rounding where the TPU kernel rounds. Where C % 64 == 0, a
  call has at least 32 tiles of 128 frames and the window fits in shared
  memory (`uses_wide_path`: the bench's B=32, T=1024, and B=4, T=1024) it
  takes the wide path: wgmma, the
  weights streamed by bulk copies in the order `pack_weights_bf16` gives
  them (128-frame tiles up to C = 256, 64-frame ones above); else (B=4,
  T=256, every shape of fewer tiles, and C % 64 != 0) the narrow path,
  mma.sync over tiles of 16 to 64 frames, which reads wd and wo as they
  are and takes no pack.
Both take every residual channel count C that is a multiple of 32 from 32
to 512 (`_build.K1_WIDTHS`, one library a width, built at first use) and
raise on any other width on the card: nothing runs the layers in their
place (JAX's DiffNet runs such widths through XLA).
Each runs its kernel (one cooperative launch for all layers) on CUDA
tensors and its plain version (`residual_stack_plain`,
`residual_stack_plain_bf16`) on CPU tensors. Inference only: on any device,
both raise when grad mode is on and an input requires grad.

The packed weights are made once per set of weights: `packed_weights_bf16`
keeps each pack beside the (wd, wo) tensors it was made from, for as long
as both live and neither is written in place (their version counters), so
the DiffNet, whose `stack_weights` keeps its stacked weights for as long as
its parameters are unchanged, packs once per set of parameters, not once a
denoiser call. A write through `.data` bypasses the version counters, and
then neither cache sees it (nothing in the port writes weights so).
`pack_counter` counts the packs made.

`write_last=True` (both routes, kernels and plain versions) also returns
the state after the last layer, which the stack otherwise never forms:
(skip, x_last), x_last in the route's state dtype (fp32, or bf16 as the
kernel keeps it). A pipeline stage (`parallel/pipeline.py`) hands it to
the next stage. A write-last launch records (B, T, C, dilations) in the
counter's shapes; a default one (B, T, C).
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import Sequence

import torch

from bisinger_tpu_torch.ops import _build

counter = _build.LaunchCounter()
counter_bf16 = _build.LaunchCounter()
pack_counter = _build.LaunchCounter()  # packs made by packed_weights_bf16

# Kernel against plain version, as max |difference| over the largest |value|
# of the plain output: both compute in fp32 and differ in summation order,
# compounded over the layers.
TOLERANCE = 2e-4
# The bf16 route against its plain version, same measure: both round the
# same bf16 values at the same places, but a sum taken in another order can
# land a value on the other side of a bf16 rounding boundary (one bf16 step
# is 2^-8 = 3.9e-3 of the value), and such a step in the gate or the hidden
# state is carried through the later layers.
TOLERANCE_BF16 = 2e-2
# ... and as mean |difference| over the mean |value|: such flips are rare,
# so the mean stays near the sound kernel's reading, while a rounding
# point moved (the `skip_dtype` control of the plain version) moves
# every value; the bound lies between the two readings (chip_smoke.py
# phase 3 reads both).
MEAN_TOLERANCE_BF16 = 4e-3


def mean_tolerance_bf16(n_layers: int) -> float:
    """The mean bound for a stack of n_layers: MEAN_TOLERANCE_BF16 is set
    for the flagship's 20 layers; a pipeline stage's 4 are held at 4 / 20
    of it, which keeps the bound between the two readings (at 4 layers the
    kernel's mean 2.9e-4, x_last's 4.2e-4, the `skip_dtype` control's
    2.35e-3 on an H100, chip_smoke.py phase 9). The kernel and its control
    were read at L=4 and L=20 only, so any other L raises: read both at it
    before adding its bound here."""
    if n_layers not in (4, 20):
        raise ValueError(f"no bf16 mean bound read for a stack of {n_layers} layers "
                         "(read at 4 and 20 only)")
    return MEAN_TOLERANCE_BF16 * n_layers / 20
RSQRT2 = 1.0 / math.sqrt(2.0)


def residual_stack_plain(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int],
                         mm=torch.matmul, write_last: bool = False):
    """The stack as plain tensor ops, the TPU kernel's arithmetic: three
    shifted products for the dilated taps, the gate, the 1x1 output
    product. Same arguments and result as `residual_stack`; `mm` takes the
    products (`_tf32.residual_stack_plain_tf32` passes TF32 ones)."""
    B, T, C = x0.shape
    x = x0
    skip = torch.zeros_like(x0)
    for l, d in enumerate(dilations):
        a = x + step_proj[l][:, None, :]
        ap = torch.nn.functional.pad(a, (0, 0, d, d))  # zeros outside [0, T)
        y = (mm(ap[:, :T], wd[l, 0]) + mm(ap[:, d:d + T], wd[l, 1]) + mm(ap[:, 2 * d:], wd[l, 2])
             + bd[l] + cond_proj[l])
        g = torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])
        z = mm(g, wo[l]) + bo[l]
        x = (x + z[..., :C]) / math.sqrt(2.0)
        skip = skip + z[..., C:]
    return (skip, x) if write_last else skip


def residual_stack_plain_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo,
                              dilations: Sequence[int], skip_dtype=torch.float32,
                              write_last: bool = False):
    """The stack with the TPU kernel's rounding (`diffnet_pallas.py:96-151`):
    the hidden state, (x + step), cond_proj, the gate and the weights bf16;
    products of bf16 values summed in fp32 (bf16 values upcast, fp32
    matmuls); biases, the gate's arithmetic and the skip sum fp32. Same
    arguments and dtypes as `residual_stack_bf16`; returns the fp32 skip.
    `skip_dtype` bfloat16 rounds the skip sum at every layer: a control,
    one rounding point moved, that the mean bound must catch."""
    B, T, C = x0.shape
    x = x0
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x0.device)
    for l, d in enumerate(dilations):
        a = (x + step_proj[l][:, None, :]).float()  # the bf16 sum, rounded
        ap = torch.nn.functional.pad(a, (0, 0, d, d))  # zeros outside [0, T)
        w = wd[l].float()
        y = ap[:, :T] @ w[0] + ap[:, d:d + T] @ w[1] + ap[:, 2 * d:] @ w[2]
        y = y + bd[l] + cond_proj[l].float()
        g = (torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])).to(torch.bfloat16)
        z = g.float() @ wo[l].float() + bo[l]
        x = ((x.float() + z[..., :C]) * RSQRT2).to(torch.bfloat16)
        skip = (skip + z[..., C:]).to(skip_dtype).float()
    return (skip, x) if write_last else skip


# The wide path's threshold (csrc/diffnet_stack_bf16.cu, `kWideTiles`
# tiles of 128 frames) and its shared memory (`wide::smem_bytes`): a ring
# of WIDE_RING stages of 16 KB and their 2 WIDE_RING mbarriers, and a
# window and gate buffer of 2 R + 2 dmax rows of C + 8 bf16 (R = 128 frames
# a tile up to C = 256, 64 above), within the 227 KB a block of sm_90 may
# take (cudaDevAttrMaxSharedMemoryPerBlockOptin, which the kernel reads)
WIDE_TILES, WIDE_FRAMES, WIDE_RING = 32, 128, 5
SMEM_MAX = 227 * 1024


def wide_smem_bytes(C: int, dmax: int) -> int:
    """The dynamic shared memory of K1-bf16's wide path at width C and
    largest dilation dmax."""
    R = WIDE_FRAMES if C <= 256 else WIDE_FRAMES // 2
    return WIDE_RING * (16 * 1024 + 16) + (2 * R + 2 * dmax) * (C + 8) * 2


def uses_wide_path(B: int, T: int, C: int = 256, dmax: int = 1) -> bool:
    """Whether K1-bf16 at this batch, length, width and largest dilation
    takes the wide path, which reads the packed weights, as the C entry
    decides: C % 64 == 0, at least WIDE_TILES tiles of 128 frames, and a
    window that fits in shared memory (at C = 256 for dilations up to 14,
    at C = 512 up to 8). Else it takes the narrow path, and no pack is
    made."""
    return (C % 64 == 0 and B * -(-T // WIDE_FRAMES) >= WIDE_TILES
            and wide_smem_bytes(C, dmax) <= SMEM_MAX)


# The wide path's ring (csrc/diffnet_stack_bf16.cu, namespace `wide`): a
# stage is PACK_KC K-rows x PACK_N columns; a layer is the dilated conv's
# passes (of PACK_N / 2 channels and their partners each), then the 1x1's.
PACK_KC, PACK_N = 64, 128


def _pack_gemm(w):
    """w [L, K, 2C] -> [L, P (pass), K / PACK_KC (stage), PACK_KC * PACK_N],
    P = 2C / PACK_N: pass p's columns are its first-half channels p*H..
    (H = PACK_N / 2) and their partners C + p*H.., interleaved by n8 tile
    (tile 2i the first half's group i, 2i + 1 the partner's); a stage is
    stored as the MN-major core matrices of the wgmma B operand: (n8 tile
    j, K group g) at (j * PACK_KC / 8 + g) * 64, K-row r % 8 at 8 more, 8
    columns contiguous."""
    L, K, C2 = w.shape
    C = C2 // 2
    P, groups = C2 // PACK_N, PACK_N // 16  # passes; n8 groups of a pass's first half
    first = w[..., :C].reshape(L, K, P, groups, 8)
    partner = w[..., C:].reshape(L, K, P, groups, 8)
    cols = torch.stack([first, partner], dim=4).reshape(L, K, P, 2 * groups, 8)
    S = K // PACK_KC
    tiles = cols.reshape(L, S, PACK_KC // 8, 8, P, 2 * groups, 8)  # [L, S, g, r, p, j, n]
    return tiles.permute(0, 4, 1, 5, 2, 3, 6).reshape(L, P, S, PACK_KC * PACK_N)


def pack_weights_bf16(wd, wo):
    """wd [L,3,C,2C] and wo [L,C,2C] (bf16, C % 64 == 0) -> [L, 4 (C/64)^2,
    PACK_KC * PACK_N] bf16, each layer's ring stages in the order the wide
    path takes them: the dilated conv's 3C / 64 stages (K = 3C rows,
    tap-major) for each of its 2C / 128 passes, then the 1x1's C / 64 for
    each (at C = 256: 12 stages for each of 4 passes, then 4 for each, 64 a
    layer). Counted in `pack_counter`."""
    L, _, C, C2 = wd.shape
    if C % PACK_KC or C2 != 2 * C or tuple(wo.shape) != (L, C, C2):
        raise ValueError(f"pack_weights_bf16 takes C % {PACK_KC} == 0, got wd "
                         f"{tuple(wd.shape)}, wo {tuple(wo.shape)}")
    conv = _pack_gemm(wd.reshape(L, 3 * C, C2)).reshape(L, -1, PACK_KC * PACK_N)
    out = _pack_gemm(wo).reshape(L, -1, PACK_KC * PACK_N)
    pack_counter.add((L, C))
    return torch.cat([conv, out], dim=1).contiguous()


def _unpack_gemm(packed, K, C):
    """The inverse of `_pack_gemm`: [L, P, S, PACK_KC * PACK_N] -> [L, K, 2C]."""
    L, P = packed.shape[:2]
    S, groups = K // PACK_KC, PACK_N // 16
    t = packed.reshape(L, P, S, 2 * groups, PACK_KC // 8, 8, 8).permute(0, 2, 4, 5, 1, 3, 6)
    cols = t.reshape(L, K, P, groups, 2, 8)  # [L, K, p, i, first/partner, n]
    return torch.cat([cols[..., 0, :].reshape(L, K, C), cols[..., 1, :].reshape(L, K, C)], -1)


def unpack_weights_bf16(packed, C: int = 256):
    """[L, 4 (C/64)^2, PACK_KC * PACK_N] -> (wd [L,3,C,2C], wo [L,C,2C]), the
    inverse of `pack_weights_bf16`."""
    L, P = packed.shape[0], 2 * C // PACK_N
    n_conv = P * 3 * C // PACK_KC
    conv = packed[:, :n_conv].reshape(L, P, n_conv // P, -1)
    out = packed[:, n_conv:].reshape(L, P, -1, PACK_KC * PACK_N)
    return _unpack_gemm(conv, 3 * C, C).reshape(L, 3, C, 2 * C), _unpack_gemm(out, C, C)


_packs = {}  # id(wd) -> (weakref(wd), weakref(wo), wd._version, wo._version, packed)


def packed_weights_bf16(wd, wo):
    """`pack_weights_bf16(wd, wo)`, made once for as long as wd and wo live
    unchanged: a later call with the same two tensors, neither written in
    place since (their version counters), returns the same pack."""
    key = id(wd)
    hit = _packs.get(key)
    if (hit is not None and hit[0]() is wd and hit[1]() is wo and hit[2] == wd._version
            and hit[3] == wo._version):
        return hit[4]
    packed = pack_weights_bf16(wd, wo)
    _packs[key] = (weakref.ref(wd, lambda _, k=key: _packs.pop(k, None)), weakref.ref(wo),
                   wd._version, wo._version, packed)
    return packed


def _check_stack(name, lib, C: int, L: int, dilations) -> None:
    """Raise ValueError unless the kernel takes width C and L layers of
    dilation >= 1."""
    _build.check_width(lib, C, name)
    if not 1 <= L <= 64 or min(dilations) < 1:
        raise ValueError(f"{name} kernel takes 1 <= L <= 64 layers of dilation >= 1, "
                         f"got L={L}, dilations {list(dilations)}")


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def residual_stack(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int],
                   write_last: bool = False):
    """x0 [B,T,C] (after the input projection), cond_proj [L,B,T,2C],
    step_proj [L,B,C], wd [L,3,C,2C], bd [L,2C], wo [L,C,2C], bo [L,2C]
    -> skip sum [B,T,C] fp32 (the caller scales by 1/sqrt(L)); with
    `write_last`, (skip, the last layer's x [B,T,C] fp32)."""
    _build.refuse_autograd("residual_stack", x0, cond_proj, step_proj, wd, bd, wo, bo)
    if x0.device.type == "cpu":
        return residual_stack_plain(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations,
                                    write_last=write_last)
    if x0.device.type != "cuda":
        raise ValueError(f"residual_stack: no kernel for device {x0.device}")
    B, T, C = x0.shape
    L = len(dilations)
    dev = x0.device
    _check("x0", x0, (B, T, C), dev)
    _check("cond_proj", cond_proj, (L, B, T, 2 * C), dev)
    _check("step_proj", step_proj, (L, B, C), dev)
    _check("wd", wd, (L, 3, C, 2 * C), dev)
    _check("bd", bd, (L, 2 * C), dev)
    _check("wo", wo, (L, C, 2 * C), dev)
    _check("bo", bo, (L, 2 * C), dev)
    _check_stack("residual_stack", "diffnet_stack", C, L, dilations)
    xbuf = torch.empty((2, B, T, C), device=dev, dtype=torch.float32)
    skip = torch.empty((B, T, C), device=dev, dtype=torch.float32)
    lib = _build.load("diffnet_stack", C)
    err = lib.diffnet_residual_stack(
        x0.data_ptr(), cond_proj.data_ptr(), step_proj.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        ctypes.cast(_build.int_array(dilations), ctypes.c_void_p),
        xbuf.data_ptr(), skip.data_ptr(), B, T, C, L, int(write_last), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "diffnet_residual_stack", lib)
    return _counted(counter, skip, xbuf, dilations, write_last)


def residual_stack_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int],
                        write_last: bool = False):
    """x0 [B,T,C] bf16, cond_proj [L,B,T,2C] bf16, step_proj [L,B,C] bf16,
    wd [L,3,C,2C] bf16, bd [L,2C] fp32, wo [L,C,2C] bf16, bo [L,2C] fp32
    -> skip sum [B,T,C] fp32 (the caller scales by 1/sqrt(L)); with
    `write_last`, (skip, the last layer's x [B,T,C] bf16)."""
    _build.refuse_autograd("residual_stack_bf16", x0, cond_proj, step_proj, wd, bd, wo, bo)
    if x0.device.type == "cpu":
        return residual_stack_plain_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations,
                                         write_last=write_last)
    if x0.device.type != "cuda":
        raise ValueError(f"residual_stack_bf16: no kernel for device {x0.device}")
    B, T, C = x0.shape
    L = len(dilations)
    dev, b16 = x0.device, torch.bfloat16
    _check("x0", x0, (B, T, C), dev, b16)
    _check("cond_proj", cond_proj, (L, B, T, 2 * C), dev, b16)
    _check("step_proj", step_proj, (L, B, C), dev, b16)
    _check("wd", wd, (L, 3, C, 2 * C), dev, b16)
    _check("bd", bd, (L, 2 * C), dev)
    _check("wo", wo, (L, C, 2 * C), dev, b16)
    _check("bo", bo, (L, 2 * C), dev)
    _check_stack("residual_stack_bf16", "diffnet_stack_bf16", C, L, dilations)
    launch, skip, xbuf = launcher_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations,
                                       write_last)
    _build.check(launch(), "diffnet_residual_stack_bf16", _build.load("diffnet_stack_bf16", C))
    return _counted(counter_bf16, skip, xbuf, dilations, write_last)


def launcher_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int],
                  write_last: bool = False):
    """(launch, skip, xbuf) for inputs that `residual_stack_bf16` has
    checked: launch() runs the kernel once into skip and xbuf, on the
    current stream, and returns the C entry point's cudaError_t (its
    cudaGetLastError after the launch), uncounted and unchecked. The
    weights are packed only for the wide path. `tools/repeat_launch.py`
    calls it back to back."""
    B, T, C = x0.shape
    L, dev = len(dilations), x0.device
    wide = uses_wide_path(B, T, C, max(dilations))
    wpack = packed_weights_bf16(wd, wo) if wide else None
    xbuf = torch.empty((2, B, T, C), device=dev, dtype=torch.bfloat16)
    skip = torch.empty((B, T, C), device=dev, dtype=torch.float32)
    lib = _build.load("diffnet_stack_bf16", C)
    args = (x0.data_ptr(), cond_proj.data_ptr(), step_proj.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            None if wpack is None else wpack.data_ptr(),
            ctypes.cast(_build.int_array(dilations), ctypes.c_void_p), xbuf.data_ptr(),
            skip.data_ptr(), B, T, C, L, int(write_last), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    entry = lib.diffnet_residual_stack_bf16

    def launch():
        return entry(*args)

    # the pack, the dilations' array and the scratch live as long as the launcher
    launch.keep = (wpack, args, xbuf, skip)
    return launch, skip, xbuf


def _counted(count, skip, xbuf, dilations, write_last: bool):
    """Count a launch and give its result: skip, or (skip, the last layer's
    x, which the kernel stored in xbuf[(L - 1) % 2])."""
    B, T, C = skip.shape
    if not write_last:
        count.add((B, T, C))
        return skip
    count.add((B, T, C, tuple(int(d) for d in dilations)))
    return skip, xbuf[(len(dilations) - 1) % 2]


def residual_stack_library(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int],
                           dtype=None):
    """The same stack as a chain of library calls in `dtype` (default: x0's):
    per layer, the dilated conv as one cuDNN `conv1d` over [B, C, T] and
    the 1x1 output projection as one cuBLAS product, with the gate and the
    sums as elementwise ops. A yardstick for timing only; the port never
    calls it. Returns the fp32 skip sum [B, T, C]."""
    dtype = dtype or x0.dtype
    C = x0.shape[-1]
    x = x0.to(dtype).transpose(1, 2)  # [B, C, T]
    skip = 0.0
    for l, d in enumerate(dilations):
        a = x + step_proj[l].to(dtype)[:, :, None]
        y = torch.nn.functional.conv1d(a, wd[l].to(dtype).permute(2, 1, 0), bd[l].to(dtype),
                                       padding=d, dilation=d)
        y = y + cond_proj[l].to(dtype).transpose(1, 2)
        g = torch.sigmoid(y[:, :C]) * torch.tanh(y[:, C:])
        z = torch.matmul(wo[l].to(dtype).t(), g) + bo[l].to(dtype)[:, None]
        x = (x + z[:, :C]) * RSQRT2
        skip = skip + z[:, C:]
    return skip.transpose(1, 2).float()


def stack_flops(B: int, T: int, C: int, L: int) -> int:
    """16*C^2 FLOP per frame per layer: 3 taps C->2C and a 1x1 C->2C."""
    return 16 * C * C * B * T * L


def stack_bytes(B: int, T: int, C: int, L: int, bf16: bool = False) -> int:
    """Each input read once and the output written once: fp32 throughout,
    or (`bf16`) bf16 x0, cond_proj, step_proj and weights with fp32 biases
    and an fp32 output."""
    act = B * T * C + L * B * T * 2 * C + L * B * C + L * 3 * C * 2 * C + L * C * 2 * C
    f32 = 2 * L * 2 * C + B * T * C  # biases, output
    return (2 if bf16 else 4) * act + 4 * f32
