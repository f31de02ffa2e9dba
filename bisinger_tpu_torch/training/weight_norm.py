"""Weight-norm reparameterisation of the GAN vocoder's kernels (counterpart
of `bisinger_tpu/training/weight_norm.py:33-104`).

Each kernel is trained as (g, v), kernel = g * v / max(||v||, 1e-12): the
reference's `torch.nn.utils.weight_norm` geometry, held outside the
modules as the JAX package holds it, so that the modules keep plain
kernels and an export folds (g, v) back into them under flax's names.
The norm is taken per output channel of a Conv1d, Conv2d or Linear and
per input channel of a ConvTranspose1d (the `up_*` kernels; flax's axis
-2): dim 0 of every torch layout. Kernels under a module path holding
`noise_conv`, `m_source` or `norm` are left plain, as the reference
leaves them.

`decompose(module)` gives the trainable leaves: "<name>.wn_g" and
"<name>.wn_v" for each such kernel, every other parameter as it is;
`compose(params)` gives the module's state_dict names back, differentiably;
`apply(module, params, *args)` runs the module on the composed kernels
(`torch.func.functional_call`); `export` folds them into the plain flat
flax dict. `flax_tree` and `load_flax_tree` write and read the leaves under
the JAX package's flat keys ("a/b/kernel/wn_g") and layouts.

`torch.nn.utils.parametrizations.weight_norm` is not used: it renames the
state_dict entries and divides by ||v|| without the 1e-12 floor.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from bisinger_tpu_torch.weights import export_flax_params, from_torch_layout, to_torch_layout

WN_SKIP = ("noise_conv", "m_source", "norm")
_KERNELS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)
_G, _V = ".wn_g", ".wn_v"


def _norm(v):
    return torch.sqrt(torch.sum(torch.square(v), dim=tuple(range(1, v.ndim)), keepdim=True))


def normed_kernels(module: nn.Module):
    """state_dict names of the kernels that train as (g, v)."""
    out = []
    for path, m in module.named_modules():
        if isinstance(m, _KERNELS) and not any(s in p for p in path.split(".") for s in WN_SKIP):
            out.append(f"{path}.weight" if path else "weight")
    return out


def decompose(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The trainable leaves of `module`: (g, v) for each normed kernel, g =
    ||kernel|| per group and v = kernel (new parameters), the module's own
    parameter for every other entry."""
    normed = set(normed_kernels(module))
    out: Dict[str, nn.Parameter] = {}
    for name, p in module.named_parameters():
        if name in normed:
            v = p.detach().clone()
            out[name + _G] = nn.Parameter(_norm(v))
            out[name + _V] = nn.Parameter(v)
        else:
            out[name] = p
    return out


def compose(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of `decompose`, differentiable: state_dict names ->
    tensors."""
    out = {}
    for name, p in params.items():
        if name.endswith(_V):
            continue
        if name.endswith(_G):
            base = name[:-len(_G)]
            v = params[base + _V]
            out[base] = p * v / torch.clamp_min(_norm(v), 1e-12)
        else:
            out[name] = p
    return out


def apply(module: nn.Module, params: Dict[str, torch.Tensor], *args, **kwargs):
    """`module(*args, **kwargs)` with the kernels composed from `params`."""
    return functional_call(module, compose(params), args, kwargs)


def export(module: nn.Module, params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Plain kernels folded from `params`, with the module's buffers, under
    flax's flat keys: the `generator_*.npz` both packages load."""
    with torch.no_grad():
        tensors = dict(module.state_dict())
        tensors.update(compose(params))
    return export_flax_params(module, tensors)


def flax_key(modules: Dict[str, nn.Module], name: str):
    """(flat flax key, owning module) of a trainable leaf's name, given the
    module tree's `dict(named_modules())`."""
    for suffix in (_G, _V):
        if name.endswith(suffix):
            mpath = name[:-len(suffix)].rpartition(".")[0]
            return "/".join([*mpath.split("."), "kernel", suffix[1:]]), modules[mpath]
    mpath, _, leaf = name.rpartition(".")
    m = modules[mpath]
    if leaf == "weight":
        leaf = "scale" if isinstance(m, nn.LayerNorm) else "kernel"
    return "/".join([*mpath.split("."), leaf]), m


def _is_kernel(key: str) -> bool:
    return key.endswith(("/kernel", "/wn_g", "/wn_v"))


def flax_tree(module: nn.Module, params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """`params` (or their gradients, under the same names) as the JAX
    package's tree, flat: "a/b/kernel/wn_g" and ".../wn_v" for a pair,
    "a/b/kernel", ".../bias", ".../scale" for the rest, in flax's layout and
    the tensors' dtype."""
    out, modules = {}, dict(module.named_modules())
    for name, t in params.items():
        key, m = flax_key(modules, name)
        arr = t.detach().cpu().numpy()
        out[key] = np.ascontiguousarray(from_torch_layout(m, arr) if _is_kernel(key) else arr)
    return out


def load_flax_tree(module: nn.Module, params: Dict[str, torch.Tensor],
                   flat: Dict[str, np.ndarray]) -> None:
    """Copy a flat flax tree (`flax_tree`'s keys, all of them) into `params`."""
    modules = dict(module.named_modules())
    by_key = {}
    for name in params:
        key, m = flax_key(modules, name)
        by_key[key] = (m, name)
    if set(by_key) != set(flat):
        raise KeyError(f"flax tree keys differ: {sorted(set(by_key) ^ set(flat))[:6]}")
    for key, arr in flat.items():
        m, name = by_key[key]
        arr = np.asarray(arr, np.float32)
        if _is_kernel(key):
            arr = to_torch_layout(m, "kernel", arr)
        with torch.no_grad():
            params[name].copy_(torch.from_numpy(np.array(arr)))
