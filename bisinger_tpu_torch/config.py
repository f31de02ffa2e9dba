"""Hyperparameters of the port: a plain dict.

Counterpart of `bisinger_tpu/config/defaults.py` and
`bisinger_tpu/config/hparams.py`, cut to the keys the port reads. A run's
settings are read from one of the repo's YAML configs (`load_hparams`,
through `yaml_subset`, with no PyYAML), from a JSON file, a JAX work dir's
`config.json` or a trained run's dump (`artifacts/flagship/hparams_*.json`).
Precedence, lowest to highest: `DEFAULTS` < the config < overrides.
Overrides are a dict or, as the CLI's `--hparams`, a "k=v,k2=[1,2]" string
(`parse_overrides`, with values typed as
`bisinger_tpu/config/hparams.py:204-250` types them).

A YAML config names its bases under `base_config` (a path or a list of
them), each resolved against the including file, then against the repo's
`configs/`, then against the current directory, and merged depth first,
a child's keys over its bases' (nested mappings merged key by key); a base
reached twice through two parents is read twice, a cycle raises
(`bisinger_tpu/config/hparams.py:146-190`).

`_explicit_keys` records which keys a file or an override set, as the JAX
package records them: a YAML config's own top-level keys (not its bases'),
a dump's own list, every key of any other JSON file, and every override
key. The step-decay schedule reads it (`training/optim.py`).
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, List, Optional

# Same values as the reference defaults (config/defaults.py) for every key
# listed; keys the slice does not read are left out.
DEFAULTS: Dict[str, Any] = {
    # audio
    "audio_num_mel_bins": 80,
    "audio_sample_rate": 24000,
    "hop_size": 128,
    "max_frames": 5000,
    # FastSpeech2MIDI conditioner
    "enc_layers": 4,
    "dec_layers": 4,
    "hidden_size": 256,
    "num_heads": 2,
    "enc_ffn_kernel_size": 9,
    "dec_ffn_kernel_size": 9,
    "ffn_act": "gelu",
    "ffn_padding": "SAME",
    "use_pos_embed": True,
    "rel_pos": True,
    "predictor_hidden": -1,
    "predictor_kernel": 5,
    "predictor_layers": 5,
    "dur_predictor_kernel": 3,
    "dur_predictor_layers": 5,
    "dur_loss": "mse",
    "use_pitch_embed": True,
    "pitch_type": "frame",
    "use_uv": True,
    "cwt_hidden_size": 128,
    "cwt_layers": 2,
    "cwt_loss": "l1",
    "cwt_add_f0_loss": False,
    "cwt_std_scale": 0.8,
    "cwt_scales": 10,
    "pitch_norm": "log",
    "pitch_loss": "l1",
    "lambda_f0": 1.0,
    "lambda_uv": 1.0,
    "use_energy_embed": False,
    "lambda_energy": 0.1,
    "use_spk_id": True,
    "use_split_spk_id": False,
    "use_spk_embed": False,
    "num_spk": 1,
    "use_midi": True,
    "use_lang_embed": True,
    "esm_cross_batch": True,
    # diffusion
    "timesteps": 1000,
    "K_step": 1000,
    "diff_decoder_type": "wavenet",
    "diff_sampler": "plms",
    "schedule_type": "linear",
    "max_beta": 0.02,
    "residual_layers": 20,
    "residual_channels": 256,
    "dilation_cycle_length": 4,
    "keep_bins": 80,
    "spec_min": [-6.0] * 80,
    "spec_max": [0.0] * 80,
    "gaussian_start": True,
    "pndm_speedup": 5,
    "dpm_steps": 40,  # read when diff_sampler is "dpmpp"
    # vocoder
    "use_nsf": True,
    "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "upsample_rates": [8, 4, 2, 2],
    "upsample_kernel_sizes": [16, 8, 4, 4],
    "upsample_initial_channel": 512,
    "vocoder_multiband": 1,
    "use_denoise": False,
    # batching
    "bucket_frames": [512, 1024, 2048, 4096],
    "bucket_tokens": [64, 128, 256, 512],
    "bucket_batch_sizes": [1, 2, 4, 8, 16, 32, 64],
    # data and training (the two acoustic stages)
    "seed": 1234,
    "work_dir": "",
    "raw_data_dir": "",
    "binary_data_dir": "",
    "raw_json_fn": "",
    "test_prefixes": [],
    "test_num": 100,
    "sort_by_len": True,
    "binarization_args": {"shuffle": False, "with_txt": True, "with_wav": False,
                          "with_align": True, "with_spk_embed": False, "with_f0": True,
                          "with_f0cwt": False},
    "processed_data_dir": "",
    "loud_norm": False,
    "reset_phone_dict": True,
    "win_size": 512,
    "fft_size": 512,
    "fmin": 30,
    "fmax": 12000,
    "wav2spec_eps": 1e-6,
    "pitch_extractor": "parselmouth",
    "pitch_norm": "log",
    "dropout": 0.1,
    "predictor_dropout": 0.5,
    "predictor_grad": 0.1,
    "mel_loss": "l1:0.5|ssim:0.5",
    "lambda_ph_dur": 1.0,
    "lambda_sent_dur": 1.0,
    "lambda_word_dur": 1.0,
    "max_words": 128,
    "diff_loss_type": "l1",
    "switch_midi2f0_step": None,
    "fs2_ckpt": "",
    "task_cls": "",
    "lr": 2.0,
    "warmup_updates": 2000,
    "optimizer_adam_beta1": 0.9,
    "optimizer_adam_beta2": 0.98,
    "weight_decay": 0.0,
    "clip_grad_norm": 1.0,
    "decay_steps": 100000,
    "accumulate_grad_batches": 1,
    "save_ckpt": True,
    "num_ckpt_keep": 3,
    "log_interval": 100,
    "num_sanity_val_steps": 5,
    "val_check_interval": 2000,
    "max_updates": 160000,
    "max_tokens": 31250,
    "max_sentences": 100000,
    "max_eval_tokens": -1,
    "max_eval_sentences": -1,
    "train_set_name": "train",
    "valid_set_name": "valid",
    "test_set_name": "test",
    "device_resident_corpus": False,
    "dataloader_prefetch": 2,
    # the (data, model) mesh: data -1 is every rank of a data-parallel run;
    # model > 1 (tensor parallelism) is not ported (parallel/mesh.py)
    "mesh_shape": {"data": -1, "model": 1},
    # inference entry points
    "pe_enable": False,  # serve f0 from a PitchExtractor (else the model's own)
    "profile_infer": False,
    # activations of the heavy stacks: "bfloat16" (bf16 products with fp32
    # sums, on the bf16 kernels) or "float32"
    "compute_dtype": "bfloat16",
}
COMPUTE_DTYPES = ("bfloat16", "float32")


def _checked(hp: Dict[str, Any]) -> Dict[str, Any]:
    if hp["compute_dtype"] not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {hp['compute_dtype']!r}")
    return hp


_BOOL_STRINGS = {"true": True, "false": False, "True": True, "False": False}


def _parse_literal(value: str) -> Any:
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        return value


def _coerce(value: str, old: Any) -> Any:
    """Type a CLI override from the existing value's type."""
    if value in _BOOL_STRINGS:
        return _BOOL_STRINGS[value]
    if old is None:
        return _parse_literal(value)
    if isinstance(old, bool):
        return value in ("1", "true", "True")
    if isinstance(old, int):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple)):
        return _parse_literal(value)
    return value


def parse_overrides(spec: str) -> Dict[str, str]:
    """Parse 'a=1,b=2' (commas inside [] are protected)."""
    out: Dict[str, str] = {}
    if not spec:
        return out
    for part in re.split(r",(?![^\[]*\])", spec):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"override {part!r} must be k=v")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _apply(hp: Dict[str, Any], overrides) -> Dict[str, Any]:
    """`overrides` onto `hp`: a dict as it is, or a string for
    `parse_overrides`, whose values are typed from the values they replace
    and whose dotted keys write into nested dicts. Their keys join
    `_explicit_keys`."""
    explicit = set(hp.get("_explicit_keys", ()))
    if isinstance(overrides, str):
        for k, v in parse_overrides(overrides).items():
            node, keys = hp, k.split(".")
            explicit.add(keys[0])
            for kk in keys[:-1]:
                node = node.setdefault(kk, {})
            node[keys[-1]] = _coerce(v, node.get(keys[-1]))
    else:
        overrides = copy.deepcopy(overrides or {})
        # a whole set of hparams (one that carries its provenance) brings its
        # own list; any other dict sets its keys explicitly
        explicit.update(overrides.pop("_explicit_keys") if "_explicit_keys" in overrides
                        else overrides)
        hp.update(overrides)
    hp["_explicit_keys"] = sorted(explicit)
    return _checked(hp)


def apply_overrides(hp: Dict[str, Any], overrides) -> Dict[str, Any]:
    """A copy of `hp` with `overrides` (a dict or a "k=v,..." string) set
    and recorded in `_explicit_keys`."""
    return _apply(copy.deepcopy(hp), overrides)


def make_hparams(overrides=None) -> Dict[str, Any]:
    """Defaults updated by `overrides` (a deep copy; callers may mutate)."""
    hp = copy.deepcopy(DEFAULTS)
    hp["_explicit_keys"] = []
    return _apply(hp, overrides)


def load_hparams_json(path: str, overrides=None) -> Dict[str, Any]:
    """Defaults < a JSON file (a run's dump, or a config of its own) <
    `overrides`."""
    with open(path) as f:
        saved = json.load(f)
    hp = copy.deepcopy(DEFAULTS)
    hp.update(saved)
    hp["_explicit_keys"] = sorted(saved["_explicit_keys"] if "_explicit_keys" in saved
                                  else saved)
    return _apply(hp, overrides)


CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs")


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_path(path: str, relative_to: Optional[str], roots: List[str]) -> str:
    if not os.path.isabs(path) and relative_to is not None:
        cand = os.path.normpath(os.path.join(os.path.dirname(relative_to), path))
        if os.path.exists(cand):
            return cand
    if os.path.isabs(path) and os.path.exists(path):
        return path
    for root in roots:
        cand = os.path.join(root, path)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"config {path!r} not found under {roots}")


def load_config_file(path: str, roots: Optional[List[str]] = None, seen=frozenset(),
                     own_keys: Optional[list] = None) -> Dict[str, Any]:
    """A YAML config with its `base_config` cascade merged in, depth first.
    `own_keys`, when given, receives the top-level keys of this file itself.
    `seen` holds this file's ancestors: a cycle raises, a diamond does not."""
    from bisinger_tpu_torch import yaml_subset

    roots = [CONFIGS_DIR, os.getcwd()] if roots is None else roots
    path = os.path.abspath(path)
    if path in seen:
        raise ValueError(f"config cycle detected at {path}")
    cfg = yaml_subset.load_file(path) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path!r}: top level must be a mapping, got "
                         f"{type(cfg).__name__}")
    if own_keys is not None:
        own_keys.extend(k for k in cfg if k != "base_config")
    bases = cfg.pop("base_config", [])
    merged: Dict[str, Any] = {}
    for base in [bases] if isinstance(bases, str) else bases:
        merged = _deep_merge(merged, load_config_file(_resolve_path(base, path, roots), roots,
                                                      seen | {path}))
    return _deep_merge(merged, cfg)


def load_hparams(path: str, overrides=None) -> Dict[str, Any]:
    """Defaults < a config (YAML with its bases, or JSON as
    `load_hparams_json` reads it) < `overrides`. A relative path is looked
    up in the repo's `configs/`, then in the current directory."""
    if path.endswith(".json"):
        return load_hparams_json(path, overrides)
    own: list = []
    cfg = load_config_file(_resolve_path(path, None, [CONFIGS_DIR, os.getcwd()]), own_keys=own)
    hp = _deep_merge(copy.deepcopy(DEFAULTS), cfg)
    hp["_explicit_keys"] = sorted(set(own) - {"_explicit_keys"})
    return _apply(hp, overrides)
