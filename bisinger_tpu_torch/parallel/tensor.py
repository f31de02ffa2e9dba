"""Tensor parallelism: the mesh's `model` axis (counterpart of `_tp_spec` and
`tensor_parallel_shardings`, `bisinger_tpu/parallel/mesh.py:90-165`), for
inference, as in JAX.

JAX places each parameter by a Megatron rule (`jax.device_put(params,
tensor_parallel_shardings(params, mesh))`) and GSPMD inserts the
collectives. The port runs that program by hand on the ranks of a
('data', 'model') mesh (`groups.make_mesh`): each rank of a model group
holds its share of every sharded weight, sliced from the full parameters,
and a layer whose product is split over its input channels all-reduces the
partial sums (`mesh.all_reduce_sum` on the model group).

The rules, on the flax-named flat keys (`tensor_parallel_shardings`, JAX's
own; the spec names the sharded axis of the flax layout):
  - `dilated_conv` and `conditioner_projection`: column-parallel over 2C
    (kernel [k, C_in, 2C] on axis 2, bias on axis 0);
  - `res_*/output_projection`: row-parallel over C (kernel [1, C, 2C] on
    axis 1); its bias is added once, after the all-reduce;
  - the HiFi-GAN's MRF `res_*/conv1_*`: column-parallel over Cout (kernel
    axis 2, bias axis 0); `res_*/conv2_*`: row-parallel over Cin (kernel
    axis 1), so that each (conv1, conv2) pair ends in one all-reduce;
  - the PitchExtractor's `mel_prenet` and `mel_encoder` 3-D kernels, and its
    `pitch_predictor`'s (in a PE tree only): column-parallel over Cout;
  - everything else replicated. A rule whose axis the model axis does not
    divide is dropped (replicated), as `mesh.py:158-162`.

Departure in layout: JAX splits a column-parallel 2C contiguously and leaves
the regathering of the gate and filter halves to XLA. The port gives model
rank r the r-th C/n slice of the gate half [0, C) and the r-th C/n slice of
the filter half [C, 2C) (its 2C/n output channels are gate_r | filter_r, in
`dilated_conv` and `conditioner_projection` alike), so that sigmoid(gate) *
tanh(filter) is local and yields channels [r C/n, (r+1) C/n) of the gated
activation, which are the input rows rank r holds of `output_projection`: a
residual layer has one all-reduce. The MRF's conv1 and the PE's convs split
Cout contiguously, rank r holding [r Cout/n, (r+1) Cout/n). The tests hold
results, not layouts.

Execution: neither fused kernel can hold a TP layer (the all-reduce falls
inside every layer, and K1 runs 20 layers in one launch, K2 a whole stage).
A sharded DiffNet runs its layer path (`DiffNet._forward_layers`, the skip
sum in compute_dtype, as flax's) and a sharded HiFi-GAN its MRF layer branch
(`HifiGanGenerator.mrf`, train mode's) in eval too: a TP rank launches no K1
and no K2, by design. A column-parallel PE conv all-gathers its channels
(`all_gather_rows(dim=-1)`) before the norm that follows it, as XLA
re-gathers in JAX. In bf16 a row-parallel product sums its partial products
in fp32 (the bf16 operands widened), all-reduces in fp32 and rounds once to
bf16 before the bias, as the unsharded layer rounds its whole product once.

Modules are swapped, not threaded: `shard_for_tp(module, mesh)` returns a
view of `module` (every other parameter shared) whose sharded layers are
replaced by their TP counterparts (`TPResidualBlock`, `TPResBlock1`,
`ColumnConv`), and marks the DiffNet and the generator it changed (`tp`).
The samplers, the PE and the vocoder call their layers as always; passing
`tp=` down, as `seq=` is, would thread an argument through every layer's
forward for the same effect. `SVSInferTorch.synthesize` finds the entered
('data', 'model') mesh (`context`) and builds the views once per (pipeline,
mesh): the conditioner, the sampler's host logic, the NSF source, the
upsamplers and every replicated layer run whole on every rank.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.common import Conv
from bisinger_tpu_torch.models.diffnet import DiffNet, ResidualBlock
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator, ResBlock1
from bisinger_tpu_torch.parallel import groups
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.parallel.groups import ProcessMesh, make_mesh  # noqa: F401
from bisinger_tpu_torch.weights import flax_shapes

AXIS = "model"


def _tp_spec(path: str, shape, is_pe_tree: bool = False) -> tuple:
    """The partition spec JAX's `_tp_spec` gives the parameter at `path` of
    flax shape `shape`: a tuple naming "model" on the sharded axis (None
    elsewhere), or () for replicated."""
    ndim = len(shape)
    kernel, bias = path.endswith("kernel"), path.endswith("bias")
    if "dilated_conv" in path or "conditioner_projection" in path:
        if kernel:
            return (None, None, AXIS)
        if bias:
            return (AXIS,)
    if "res_" in path and "output_projection" in path and kernel:
        return (None, AXIS, None)
    if "res_" in path and "/conv1_" in path:
        if kernel:
            return (None, None, AXIS)
        if bias:
            return (AXIS,)
    if "res_" in path and "/conv2_" in path and kernel:
        return (None, AXIS, None)
    if any(m in path for m in ("mel_prenet", "mel_encoder")) and kernel and ndim == 3:
        return (None, None, AXIS)
    if is_pe_tree and "pitch_predictor" in path and kernel and ndim == 3:
        return (None, None, AXIS)
    return ()


def tensor_parallel_shardings(params: Dict[str, object], mesh) -> Dict[str, tuple]:
    """The spec of every key of a flat flax tree (`{key: array}`, or `{key:
    shape}`) over `mesh`'s model axis (`mesh.shape["model"]`), as JAX's
    `tensor_parallel_shardings`: `_tp_spec`'s, dropped to () where the axis
    does not divide the dim. The PE's `pitch_predictor` rule applies in a PE
    tree only (one with a top-level `mel_prenet` or `mel_encoder`)."""
    shapes = {k: tuple(v) if isinstance(v, tuple) else tuple(np.shape(v))
              for k, v in params.items()}
    top = {k.split("/", 1)[0] for k in shapes}
    is_pe_tree = "mel_prenet" in top or "mel_encoder" in top
    n = mesh.shape[AXIS]
    out = {}
    for k, shape in shapes.items():
        spec = _tp_spec(k, shape, is_pe_tree)
        if any(name == AXIS and shape[a] % n for a, name in enumerate(spec)):
            spec = ()
        out[k] = spec
    return out


def sharded_axis(spec: tuple) -> Optional[int]:
    """The flax axis a spec shards, or None."""
    return spec.index(AXIS) if AXIS in spec else None


def context() -> Optional[ProcessMesh]:
    """The entered ('data', 'model') mesh with a model axis above 1, else
    None (`SVSInferTorch.synthesize` runs unsharded)."""
    m = groups.ambient(AXIS)
    return m if m is not None and m.size > 1 else None


# ---- the TP layers ------------------------------------------------------------------
def _with_params(layer: nn.Module, weight, bias) -> nn.Module:
    """A copy of `layer` (a Conv or Linear: same dtype, stride, padding,
    dilation) holding `weight` and `bias` (None: no bias) instead."""
    out = copy.copy(layer)
    out.__dict__["_parameters"] = {
        "weight": nn.Parameter(weight.detach().contiguous(), requires_grad=False),
        "bias": None if bias is None else nn.Parameter(bias.detach().contiguous(),
                                                       requires_grad=False)}
    return out


class RowParallel(nn.Module):
    """A Linear or Conv whose input channels [lo, hi) this rank holds: the
    partial product (in bf16 the operands rounded to bf16, then summed in
    fp32), summed over the model group, rounded once to the compute dtype,
    then the whole bias added in it."""

    def __init__(self, layer: nn.Module, lo: int, hi: int, group):
        super().__init__()
        self.part = _with_params(layer, layer.weight[:, lo:hi], None)
        self.bias = nn.Parameter(layer.bias.detach(), requires_grad=False)
        self.dtype_ = layer.compute_dtype or torch.float32
        self.group = group

    def forward(self, x):
        dt, w = self.dtype_, self.part.weight
        if dt == torch.float32:  # the parameters' dtype, as the layers read it
            xw, ww = x.to(w.dtype), w
        else:
            xw, ww = x.to(dt).float(), w.to(dt).float()
        if isinstance(self.part, nn.Conv1d):
            p = self.part
            y = F.conv1d(xw.transpose(1, 2), ww, None, p.stride, p.padding,
                         p.dilation).transpose(1, 2)
        else:
            y = F.linear(xw, ww)
        y = dp.all_reduce_sum(y, group=self.group)
        return y + self.bias if dt == torch.float32 else y.to(dt) + self.bias.to(dt)


class ColumnConv(nn.Module):
    """A Conv whose output channels [lo, hi) this rank computes; the ranks'
    channels are gathered (exactly, in fp32) into the whole output."""

    def __init__(self, conv: Conv, lo: int, hi: int, group):
        super().__init__()
        self.conv = _with_params(conv, conv.weight[lo:hi], conv.bias[lo:hi])
        self.group = group

    def forward(self, x):
        y = self.conv(x)
        return dp.all_gather_rows(y.float(), group=self.group, dim=-1).to(y.dtype)


def _share(c: int, m: ProcessMesh):
    k = c // m.size
    return m.index * k, (m.index + 1) * k


class TPResidualBlock(ResidualBlock):
    """A DiffNet `ResidualBlock`'s model-rank share, run by its `forward`:
    `dilated_conv` and `conditioner_projection` column-parallel on this
    rank's gate and filter slices, `output_projection` row-parallel on the
    matching C/n input channels (`RowParallel`: the layer's one all-reduce),
    `diffusion_projection` replicated. Its conditioner projection is
    [B, T, 2C/n] (gate_r | filter_r)."""

    def __init__(self, blk: ResidualBlock, m: ProcessMesh):
        nn.Module.__init__(self)
        c = blk.dilated_conv.out_channels // 2
        lo, hi = _share(c, m)
        idx = torch.cat([torch.arange(lo, hi), c + torch.arange(lo, hi)]).to(
            blk.dilated_conv.weight.device)
        self.dilation = blk.dilation
        self.diffusion_projection = blk.diffusion_projection
        dc, cp = blk.dilated_conv, blk.conditioner_projection
        self.dilated_conv = _with_params(dc, dc.weight[idx], dc.bias[idx])
        self.conditioner_projection = _with_params(cp, cp.weight[idx], cp.bias[idx])
        self.output_projection = RowParallel(blk.output_projection, lo, hi, m.group)


class TPResBlock1(ResBlock1):
    """A HiFi-GAN `ResBlock1`'s model-rank share, run by its `forward`: per
    dilation conv1 column-parallel (Cout/n), conv2 row-parallel over those
    channels (`RowParallel`: all-reduce, + bias), added to the state."""

    def __init__(self, blk: ResBlock1, m: ProcessMesh):
        nn.Module.__init__(self)
        self.dilations = list(blk.dilations)
        for i in range(len(self.dilations)):
            c1 = getattr(blk, f"conv1_{i}")
            lo, hi = _share(c1.out_channels, m)
            self.add_module(f"conv1_{i}", _with_params(c1, c1.weight[lo:hi], c1.bias[lo:hi]))
            self.add_module(f"conv2_{i}", RowParallel(getattr(blk, f"conv2_{i}"), lo, hi,
                                                      m.group))


# ---- the module view ------------------------------------------------------------------
def _view(module: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every parameter and buffer:
    replacing a submodule of the copy leaves `module` as it is."""
    out = copy.copy(module)
    d = out.__dict__
    d["_parameters"] = dict(module._parameters)
    d["_buffers"] = dict(module._buffers)
    d["_modules"] = {k: None if v is None else _view(v) for k, v in module._modules.items()}
    return out


def shard_for_tp(module: nn.Module, m: ProcessMesh) -> nn.Module:
    """A view of `module` with this model rank's share of every layer that
    `tensor_parallel_shardings` shards (module docstring): the DiffNet's
    residual blocks, the HiFi-GAN's ResBlock1s and the column-parallel convs
    (the PE's). Everything else is shared with `module`, replicated. A
    DiffNet or generator with a sharded block gets `tp = m` (its layer path
    in eval)."""
    m.check_member()
    specs = tensor_parallel_shardings(flax_shapes(module), m)

    def spec(name, leaf):  # () where replicated
        return specs.get("/".join([*name.split("."), leaf]) if name else leaf, ())

    swaps = {}
    for name, sub in module.named_modules():
        if any(name.startswith(p + ".") for p in swaps):
            continue
        if isinstance(sub, ResidualBlock) and spec(name, "dilated_conv/kernel"):
            swaps[name] = TPResidualBlock(sub, m)
        elif isinstance(sub, ResBlock1) and spec(name, "conv1_0/kernel"):
            swaps[name] = TPResBlock1(sub, m)
        elif isinstance(sub, Conv) and spec(name, "kernel") == (None, None, AXIS):
            swaps[name] = ColumnConv(sub, *_share(sub.out_channels, m), m.group)
    view = _view(module)
    for name, new in swaps.items():
        parent, _, leaf = name.rpartition(".")
        holder = view.get_submodule(parent) if parent else view
        setattr(holder, leaf, new)
        if isinstance(holder, (DiffNet, HifiGanGenerator)):
            holder.tp = m
    return view
