"""Import the reference's PyTorch vocoder checkpoints (HiFi-GAN, Parallel
WaveGAN, MelGAN) as flax-named parameter trees (the port's copy of
`bisinger_tpu/vocoders/torch_import.py:30-188`).

The trees are the JAX package's, leaf for leaf (numpy float32):
`weights.flatten_tree` of one goes into `weights.load_flax_params` of the
port's generator. Conversion rules:

  - Conv1d weight [out, in, k]        -> flax Conv kernel [k, in, out]
  - ConvTranspose1d weight [in, out, k] -> flax ConvTranspose (SAME, no
    kernel transpose) kernel: the taps reversed, then [k, in, out]
  - Linear weight [out, in]           -> flax Dense kernel [in, out]
  - weight norm (`<name>.weight_g`, `<name>.weight_v`) folded first:
    w = g * v / max(||v||, 1e-12), the norm over every axis but 0.

`load_torch_checkpoint` reads a .ckpt / .pt with `torch.load(...,
weights_only=True)`: tensors, containers and plain values only. A
checkpoint that needs any other object unpickled is refused with an error
that names the file (the JAX package unpickles with weights_only=False,
which runs whatever code the file names; ROADMAP Queue 3).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np


def fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold `<name>.weight_g` + `<name>.weight_v` -> `<name>.weight`."""
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            g = np.asarray(sd[base + ".weight_g"], np.float32)
            v = np.asarray(val, np.float32)
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out[base + ".weight"] = g * v / np.maximum(norm, 1e-12)
        elif key.endswith(".weight_g"):
            continue
        else:
            out[key] = np.asarray(val)
    return out


def _conv(sd, name):
    w = sd[name + ".weight"]  # [out, in, k]
    p = {"kernel": w.transpose(2, 1, 0).copy()}
    if name + ".bias" in sd:
        p["bias"] = sd[name + ".bias"]
    return p


def _conv_transpose(sd, name):
    w = sd[name + ".weight"]  # [in, out, k]
    p = {"kernel": w[:, :, ::-1].transpose(2, 0, 1).copy()}
    if name + ".bias" in sd:
        p["bias"] = sd[name + ".bias"]
    return p


def _dense(sd, name):
    w = sd[name + ".weight"]  # [out, in]
    p = {"kernel": w.transpose(1, 0).copy()}
    if name + ".bias" in sd:
        p["bias"] = sd[name + ".bias"]
    return p


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def import_hifigan_generator(state_dict: Dict[str, Any], hp) -> Dict[str, Any]:
    """Torch HiFi-GAN generator state dict (ResBlock1 or ResBlock2, NSF or
    not) -> the flax `HifiGanGenerator` tree. The reference's noise norm is
    a parameterless layer_norm: the tree gets an identity scale and bias
    for the flax LayerNorm."""
    sd = fold_weight_norm({k: np.asarray(v) for k, v in state_dict.items()})
    n_up = len(hp["upsample_rates"])
    n_k = len(hp["resblock_kernel_sizes"])
    n_dil = len(hp["resblock_dilation_sizes"][0])

    params: Dict[str, Any] = {"conv_pre": _conv(sd, "conv_pre"),
                              "conv_post": _conv(sd, "conv_post")}
    for i in range(n_up):
        params[f"up_{i}"] = _conv_transpose(sd, f"ups.{i}")
        for j in range(n_k):
            blk: Dict[str, Any] = {}
            tname = f"resblocks.{i * n_k + j}"
            for d in range(n_dil):
                if f"{tname}.convs1.{d}.weight" in sd:  # ResBlock1
                    blk[f"conv1_{d}"] = _conv(sd, f"{tname}.convs1.{d}")
                    blk[f"conv2_{d}"] = _conv(sd, f"{tname}.convs2.{d}")
                else:  # ResBlock2
                    blk[f"conv_{d}"] = _conv(sd, f"{tname}.convs.{d}")
            params[f"res_{i}_{j}"] = blk
        if f"noise_convs.{i}.weight" in sd:
            params[f"noise_conv_{i}"] = _conv(sd, f"noise_convs.{i}")
            c_out = params[f"noise_conv_{i}"]["kernel"].shape[-1]
            params[f"noise_norm_{i}"] = {"scale": np.ones(c_out, np.float32),
                                         "bias": np.zeros(c_out, np.float32)}
    if "m_source.l_linear.weight" in sd:
        params["m_source"] = {"merge": _dense(sd, "m_source.l_linear")}
    return _f32(params)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch .ckpt / .pt file -> the generator's state dict as numpy
    (`state_dict.model_gen`, `generator`, `state_dict` or the file's own
    dict; a lightning-style "model_gen." prefix dropped)."""
    import torch

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: the checkpoint holds objects beyond tensors and plain containers, and is "
            f"not unpickled (weights_only=True; unpickling runs the code a file names). Save "
            f"the generator's state_dict alone and import that. ({str(e).splitlines()[0]})"
        ) from None
    if "state_dict" in ckpt and "model_gen" in ckpt["state_dict"]:
        sd = ckpt["state_dict"]["model_gen"]
    elif "generator" in ckpt:
        sd = ckpt["generator"]
    elif "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    out = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    if out and all(k.startswith("model_gen.") for k in out):
        out = {k[len("model_gen."):]: v for k, v in out.items()}
    return out


def import_pwg_generator(state_dict: Dict[str, Any], hp) -> Dict[str, Any]:
    """Torch ParallelWaveGANGenerator state dict (reference layout
    `modules/parallel_wavegan/models/parallel_wavegan.py:18-120`) -> the
    flax `ParallelWaveGANGenerator` tree; the upsample net's Conv2d weights
    [1, 1, 1, 2s + 1] become the shared time kernels [2s + 1, 1, 1]."""
    sd = fold_weight_norm({k: np.asarray(v) for k, v in state_dict.items()})
    scales = list(hp.get("pwg_upsample_scales", [4, 4, 4, 2]))
    params: Dict[str, Any] = {"first_conv": _conv(sd, "first_conv")}
    up_net = {}
    for i in range(len(scales)):  # up_layers interleave [Stretch2d, Conv2d, ...]
        w2d = sd[f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"]
        up_net[f"conv_{i}_kernel"] = w2d[0, 0, 0, :].reshape(-1, 1, 1).copy()
    params["upsample_net"] = {"conv_in": _conv(sd, "upsample_net.conv_in"),
                              "upsample": up_net}
    n_layers = 0
    while f"conv_layers.{n_layers}.conv.weight" in sd:
        n_layers += 1
    for i in range(n_layers):
        params[f"block_{i}"] = {
            "conv": _conv(sd, f"conv_layers.{i}.conv"),
            "aux_conv": _conv(sd, f"conv_layers.{i}.conv1x1_aux"),
            "skip_conv": _conv(sd, f"conv_layers.{i}.conv1x1_skip"),
            "out_conv": _conv(sd, f"conv_layers.{i}.conv1x1_out"),
        }
    params["post_conv_1"] = _conv(sd, "last_conv_layers.1")
    params["post_conv_2"] = _conv(sd, "last_conv_layers.3")
    return _f32(params)


def import_melgan_generator(state_dict: Dict[str, Any], hp) -> Dict[str, Any]:
    """Torch MelGANGenerator state dict (the reference's Sequential
    `melgan.*`: index 1 the pre conv; per scale i, 3 + 5i the transposed
    conv and 4 + 5i + j residual stack j; 4 + 5n the post conv) -> the flax
    `MelGanGenerator` tree."""
    sd = fold_weight_norm({k: np.asarray(v) for k, v in state_dict.items()})
    scales = list(hp.get("melgan_upsample_scales", [8, 8, 2, 2]))
    params: Dict[str, Any] = {"conv_pre": _conv(sd, "melgan.1")}
    for i in range(len(scales)):
        params[f"up_{i}"] = _conv_transpose(sd, f"melgan.{3 + 5 * i}")
        res: Dict[str, Any] = {}
        for j in range(3):
            base = f"melgan.{4 + 5 * i + j}"
            res[f"conv_{j}"] = _conv(sd, f"{base}.stack.2")
            res[f"out_{j}"] = _conv(sd, f"{base}.stack.4")
            res[f"skip_{j}"] = _conv(sd, f"{base}.skip_layer")
        params[f"res_{i}"] = res
    params["conv_post"] = _conv(sd, f"melgan.{4 + 5 * len(scales)}")
    return _f32(params)
