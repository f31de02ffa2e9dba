"""K1-bf16's packed weights (`ops/diffnet_stack.py` `pack_weights_bf16`) on
the CPU, where no kernel runs.

The wide path of `csrc/diffnet_stack_bf16.cu` streams each layer's weights
as ring stages, one bulk copy each, in the order and shared-memory layout
the pack gives them: for each layer the dilated conv's four passes (12
stages of 64 K-rows each), then the 1x1's four passes (4 each); a pass's
128 columns are 64 first-half channels (gate, or residual) interleaved by
n8 tile with their partners (filter, or skip); a stage is stored as the
MN-major core matrices of the wgmma B operand. The pack is made once per
set of parameters: the DiffNet keeps its stacked weights while its
parameters are unchanged, and `packed_weights_bf16` keeps a pack beside
the tensors it was made from. The pack takes C = 256 only, K1's one width;
the layers are few.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, VOCAB, midi_batch, t

from bisinger_tpu_torch.config import make_hparams
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.ops import diffnet_stack
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params

C, L = 256, 4


def _model(seed=0):
    hp = make_hparams(dict(TINY, residual_channels=C, residual_layers=L,
                           compute_dtype="bfloat16"))
    torch.manual_seed(seed)
    return GaussianDiffusion(hp, VOCAB).eval()


def _stack(net):
    with torch.no_grad():
        return net.stack_weights()


def test_packed_weights_unpack_to_the_flax_named_tensors():
    net = _model().denoise_fn
    wd, wo = _stack(net)[2], _stack(net)[4]
    packed = diffnet_stack.pack_weights_bf16(wd, wo)
    assert packed.shape == (L, 64, 64 * 128) and packed.dtype == torch.bfloat16
    got_wd, got_wo = diffnet_stack.unpack_weights_bf16(packed)
    flax = export_flax_params(net)
    for layer in range(L):
        kd = torch.from_numpy(flax[f"res_{layer}/dilated_conv/kernel"])  # [3, C, 2C]
        ko = torch.from_numpy(flax[f"res_{layer}/output_projection/kernel"])  # [1, C, 2C]
        assert torch.equal(got_wd[layer], kd.to(torch.bfloat16))
        assert torch.equal(got_wo[layer], ko[0].to(torch.bfloat16))


# The layout the kernel reads, element by element: stage s of pass p of a
# layer's GEMM holds K-row k of the stage (KC = 64 rows) and n8 tile j (of
# N = 128 columns) at core matrix (j * KC / 8 + k // 8) * 64, row k % 8 at 8
# more, column n of the tile at n; tile 2i is first-half channel p*64 + 8i +
# n, tile 2i + 1 its partner C + ...; the dilated conv's 4 passes of 12
# stages come first, then the 1x1's 4 passes of 4.
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_places_each_weight_where_the_kernel_reads_it(seed):
    KC, N = diffnet_stack.PACK_KC, diffnet_stack.PACK_N
    assert (KC, N) == (64, 128)
    g = torch.Generator().manual_seed(seed)
    wd = torch.randn((L, 3, C, 2 * C), generator=g).to(torch.bfloat16)
    wo = torch.randn((L, C, 2 * C), generator=g).to(torch.bfloat16)
    packed = diffnet_stack.pack_weights_bf16(wd, wo)
    r = np.random.default_rng(seed)
    for _ in range(200):
        layer, p, k, j, n = (int(r.integers(v)) for v in (L, 4, KC, N // 8, 8))
        ch = (C if j % 2 else 0) + p * (N // 2) + (j // 2) * 8 + n
        at = (j * KC // 8 + k // 8) * 64 + (k % 8) * 8 + n
        s = int(r.integers(12))  # a stage of the dilated conv: tap s // 4
        K = s * KC + k
        assert packed[layer, p * 12 + s, at] == wd[layer, K // C, K % C, ch]
        s = int(r.integers(4))  # a stage of the 1x1
        assert packed[layer, 48 + p * 4 + s, at] == wo[layer, s * KC + k, ch]


def test_plain_stack_on_the_unpacked_weights_is_bit_identical():
    g = torch.Generator().manual_seed(3)
    B, T = 2, 40
    b16 = torch.bfloat16
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g)  # noqa: E731
    x0, cond, step = (torch.relu(r(B, T, C)).to(b16), r(L, B, T, 2 * C).to(b16),
                      r(L, B, C, sc=0.5).to(b16))
    wd, wo = r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5).to(b16), r(L, C, 2 * C, sc=C ** -0.5).to(b16)
    bd, bo = r(L, 2 * C, sc=0.1), r(L, 2 * C, sc=0.1)
    dils = [1, 2, 4, 8]
    back_wd, back_wo = diffnet_stack.unpack_weights_bf16(diffnet_stack.pack_weights_bf16(wd, wo))
    ref = diffnet_stack.residual_stack_plain_bf16(x0, cond, step, wd, bd, wo, bo, dils)
    got = diffnet_stack.residual_stack_plain_bf16(x0, cond, step, back_wd, bd, back_wo, bo, dils)
    assert torch.equal(got, ref)


def test_a_synthesis_packs_once_per_set_of_parameters():
    """Two PLMS loops of 9 denoiser calls each pack once; a parameter
    written in place, or weights loaded, pack anew. On the CPU K1 runs its
    plain version, so the card route's first step, `packed_weights_bf16` on
    the (wd, wo) that reach it, is run beside it."""
    model = _model()
    net = model.denoise_fn
    calls = []

    def card_route(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations, **kw):
        calls.append(diffnet_stack.packed_weights_bf16(wd, wo))
        return diffnet_stack.residual_stack_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo,
                                                 dilations, **kw)

    net.stack_fn = lambda: card_route
    batch = midi_batch(b=1, n_tokens=8, n_frames=24)
    cond = {k: t(batch[k]) for k in ("pitch_midi", "midi_dur", "is_slur", "lang", "speechsing")}

    def synthesize():
        with torch.no_grad():
            model(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]),
                  spk_id=t(batch["spk_ids"]), generator=torch.Generator().manual_seed(0), **cond)

    n_calls = model.hp["K_step"] // model.hp["pndm_speedup"] + 1
    packs = diffnet_stack.pack_counter.launches
    synthesize()
    synthesize()
    assert len(calls) == 2 * n_calls
    assert diffnet_stack.pack_counter.launches == packs + 1
    assert all(c is calls[0] for c in calls)
    with torch.no_grad():
        net.res_1.output_projection.weight.mul_(0.5)  # a parameter written in place
    synthesize()
    assert diffnet_stack.pack_counter.launches == packs + 2
    assert torch.equal(diffnet_stack.unpack_weights_bf16(calls[-1])[1][1],
                       net.res_1.output_projection.weight.t().to(torch.bfloat16))
    load_flax_params(net, export_flax_params(_model(seed=1).denoise_fn))  # weights loaded
    synthesize()
    assert diffnet_stack.pack_counter.launches == packs + 3
    assert len(calls) == 4 * n_calls


# The wrapper packs the weights only where the kernel takes its wide path:
# from kWideTiles 128-frame tiles (csrc/diffnet_stack_bf16.cu), the number
# `WIDE_TILES` repeats
@pytest.mark.parametrize("B,T,wide", [(4, 256, False), (1, 32, False), (3, 1000, False),
                                      (4, 1024, True), (4, 1000, True), (32, 1024, True),
                                      (15, 129, False), (16, 129, True)])
def test_the_weights_are_packed_only_for_the_wide_path(B, T, wide):
    import os
    import re

    with open(os.path.join(os.path.dirname(diffnet_stack.__file__), "..", "csrc",
                           "diffnet_stack_bf16.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kWideTiles = (\d+);", src).group(1)) == \
        diffnet_stack.WIDE_TILES
    assert int(re.search(r"constexpr int R = (\d+);", src).group(1)) == diffnet_stack.WIDE_FRAMES
    assert diffnet_stack.uses_wide_path(B, T) is wide
