"""Hyperparameters of the port: a plain dict.

Counterpart of `bisinger_tpu/config/defaults.py` and
`bisinger_tpu/config/hparams.py`, cut to the keys the inference slice
reads and without YAML: a trained run's settings are read from its JSON
dump (`artifacts/flagship/hparams_diff.json`). Precedence, lowest to
highest: `DEFAULTS` < JSON file < overrides.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Optional

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
    "dur_predictor_kernel": 3,
    "dur_predictor_layers": 5,
    "dur_loss": "mse",
    "use_pitch_embed": True,
    "pitch_type": "frame",
    "use_uv": True,
    "pitch_norm": "log",
    "use_energy_embed": False,
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


def make_hparams(overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Defaults updated by `overrides` (a deep copy; callers may mutate)."""
    hp = copy.deepcopy(DEFAULTS)
    hp.update(copy.deepcopy(overrides or {}))
    return _checked(hp)


def load_hparams_json(path: str, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Defaults < the JSON dump of a trained run < `overrides`."""
    with open(path) as f:
        saved = json.load(f)
    saved.pop("_explicit_keys", None)
    hp = make_hparams(saved)
    hp.update(copy.deepcopy(overrides or {}))
    return _checked(hp)
