"""Load flax parameter trees, saved as flat "/"-joined npz files, into the
port's modules.

Counterpart, in the inverse direction, of `bisinger_tpu/compat/torch_params.py`
and `bisinger_tpu/vocoders/torch_import.py`; the flat-key format is that of
`bisinger_tpu/vocoders/hifigan.py` (`flatten_params` / `unflatten_params`).
The port's modules carry the flax names, so a key maps to a state_dict
entry by path: "fs2/encoder/layer_0/ffn/Conv_0/kernel" is
"fs2.encoder.layer_0.ffn.Conv_0.weight". Layouts:

- Conv kernel (k, in, out) -> Conv1d weight (out, in, k), grouped too
  (flax (k, in / groups, out), torch (out, in / groups, k));
- 2-D Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw);
- Dense kernel (in, out), or a 1x1 Conv kernel (1, in, out) held by an
  nn.Linear, -> Linear weight (out, in);
- ConvTranspose kernel (k, in, out) (flax, no kernel flip) -> torch
  ConvTranspose1d weight (in, out, k) with the taps reversed, as
  `models/hifigan.py:306` lays it out;
- LayerNorm/GroupNorm/BatchNorm "scale" -> weight; BatchNorm "mean"/"var"
  -> running_mean/running_var; Embed "embedding" -> weight.

Loading fails on a key that maps onto nothing, on a shape mismatch, and on
any parameter or buffer of the module that no key filled.
`export_flax_params` is the inverse: a module's parameters and buffers as
that flat dict (a port `Linear` marked `conv1x1` gives a 1x1 Conv kernel).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn

_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "embedding": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax tree (dicts of arrays) -> the flat "/"-joined dict that
    `load_flax_params` takes."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def torch_key(flax_key: str) -> tuple:
    """"a/b/kernel" -> ("a.b", "weight")."""
    *path, leaf = flax_key.split("/")
    return ".".join(path), _LEAF.get(leaf, leaf)


def to_torch_layout(module: nn.Module, flax_leaf: str, arr: np.ndarray) -> np.ndarray:
    if flax_leaf != "kernel":
        return arr
    if isinstance(module, nn.ConvTranspose1d):
        return arr[::-1].transpose(1, 2, 0)
    if isinstance(module, nn.Conv1d):
        return arr.transpose(2, 1, 0)
    if isinstance(module, nn.Conv2d):
        return arr.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear):
        return (arr[0] if arr.ndim == 3 else arr).T
    raise TypeError(f"no kernel layout for {type(module).__name__}")


def load_flax_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Fill every parameter and buffer of `model` from `flat`; raise on any
    unused key, shape mismatch or unfilled entry."""
    modules = dict(model.named_modules())
    state = model.state_dict()
    filled = set()
    for key, arr in flat.items():
        mpath, name = torch_key(key)
        tkey = f"{mpath}.{name}" if mpath else name
        if tkey not in state:
            raise KeyError(f"{key!r} maps onto nothing in {type(model).__name__} ({tkey})")
        arr = to_torch_layout(modules[mpath], key.rsplit("/", 1)[-1], np.asarray(arr))
        target = state[tkey]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{key!r}: shape {arr.shape} != {tuple(target.shape)} of {tkey}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        filled.add(tkey)
    missing = unfilled(state.keys(), filled)
    if missing:
        raise KeyError(f"{type(model).__name__}: not filled by any key: {missing[:8]}"
                       + (f" (+{len(missing) - 8} more)" if len(missing) > 8 else ""))


def unfilled(state_keys: Iterable[str], filled: Iterable[str]) -> list:
    filled = set(filled)
    return [k for k in state_keys if k not in filled and not k.endswith("num_batches_tracked")]


_FLAX_WEIGHT = ((nn.Embedding, "embedding"),
                ((nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d), "scale"),
                ((nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d), "kernel"))
_FLAX_LEAF = {"bias": "bias", "running_mean": "mean", "running_var": "var"}


def from_torch_layout(module: nn.Module, arr: np.ndarray) -> np.ndarray:
    """The inverse of `to_torch_layout` for a weight."""
    if isinstance(module, nn.ConvTranspose1d):
        return arr.transpose(2, 0, 1)[::-1]
    if isinstance(module, nn.Conv1d):
        return arr.transpose(2, 1, 0)
    if isinstance(module, nn.Conv2d):
        return arr.transpose(2, 3, 1, 0)
    if isinstance(module, nn.Linear):
        return arr.T[None] if getattr(module, "conv1x1", False) else arr.T
    return arr


def _is_kernel(key: str, name: str) -> bool:
    return name == "weight" and key.rsplit("/", 1)[-1] == "kernel"


def flax_entries(model: nn.Module, tensors=None):
    """(flat flax key, module, state_dict name, value) of every entry
    `export_flax_params` exports, in state_dict order; `tensors` as there."""
    modules = dict(model.named_modules())
    for tkey, value in (model.state_dict() if tensors is None else tensors).items():
        if tkey.endswith("num_batches_tracked"):
            continue
        mpath, _, name = tkey.rpartition(".")
        module = modules[mpath]
        if name == "weight":
            leaf = next(flax for kinds, flax in _FLAX_WEIGHT if isinstance(module, kinds))
        else:
            leaf = _FLAX_LEAF.get(name, name)
        yield "/".join([*mpath.split("."), leaf]) if mpath else leaf, module, name, value


def export_flax_params(model: nn.Module, tensors=None) -> Dict[str, np.ndarray]:
    """Every parameter and buffer of `model` (but BatchNorm's step count and
    non-persistent buffers) under its flat flax key, in flax's layout, as
    fp32 numpy arrays: `load_flax_params(model, export_flax_params(model))`
    changes nothing; the arrays are copies, which a later optimizer step
    leaves as they were. `tensors` (state_dict names -> tensors, default the
    state_dict) exports other values of the same entries, such as weights
    composed from a weight-norm pair."""
    out: Dict[str, np.ndarray] = {}
    for key, module, name, value in flax_entries(model, tensors):
        arr = value.detach().float().cpu().numpy()
        if _is_kernel(key, name):
            arr = from_torch_layout(module, arr)
        # a copy: a CPU tensor's .numpy() is a view of the live parameter
        out[key] = np.array(arr, order="C")
    return out


def flax_shapes(model: nn.Module) -> Dict[str, tuple]:
    """The flax-layout shape of every entry `export_flax_params` exports,
    without copying a value."""
    out = {}
    for key, module, name, value in flax_entries(model):
        arr = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8), tuple(value.shape),
                                              (0,) * value.dim())
        out[key] = (from_torch_layout(module, arr) if _is_kernel(key, name) else arr).shape
    return out
