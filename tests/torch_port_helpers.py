"""Shared pieces of the port's parity tests (tests/test_torch_*.py): tiny
hyperparameters for both packages, numpy inputs from a seed, and moving
flax parameters into a port module through a "/"-joined npz file."""

import jax
import numpy as np
import torch

from bisinger_tpu.config import load_hparams
from bisinger_tpu.vocoders.hifigan import flatten_params
from bisinger_tpu_torch.config import make_hparams
from bisinger_tpu_torch.weights import load_flax_params, load_npz

torch.set_num_threads(1)

VOCAB = 20

# small widths, fp32 on both sides; the flagship's structure otherwise
TINY = dict(
    hidden_size=32,
    enc_layers=1,
    dec_layers=2,
    num_heads=2,
    enc_ffn_kernel_size=3,
    dec_ffn_kernel_size=3,
    dur_predictor_layers=2,
    predictor_layers=2,
    residual_layers=4,
    residual_channels=32,
    dilation_cycle_length=4,
    use_pitch_embed=False,
    rel_pos=False,
    num_spk=4,
    compute_dtype="float32",
    timesteps=40,
    K_step=40,
    pndm_speedup=5,
    upsample_initial_channel=64,
    pe_enable=True,
)


def hparams(**kw):
    """(JAX HParams, port dict) from the same overrides."""
    over = dict(TINY, **kw)
    return load_hparams(overrides=over), make_hparams(over)


def to_port(module, params, tmp_path, name="params.npz", extra=None):
    """Write flax `params` (and `extra`, e.g. batch_stats) as a flat npz in
    `tmp_path`, load it into the port `module`, return it in eval mode."""
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    if extra is not None:
        flat.update({k: np.asarray(v) for k, v in flatten_params(jax.device_get(extra)).items()})
    path = tmp_path / name
    np.savez(path, **flat)
    load_flax_params(module, load_npz(str(path)))
    return module.eval()


def noisy(params, path, seed, scale=0.1):
    """Replace the leaf at `path` (a tuple of keys) with noise: zero-initialised
    output layers would make a comparison vacuous."""
    node = params
    for key in path[:-1]:
        node = node[key]
    leaf = np.asarray(node[path[-1]])
    node[path[-1]] = scale * np.random.default_rng(seed).standard_normal(leaf.shape).astype(
        np.float32)
    return params


def midi_batch(b=2, n_tokens=8, n_frames=32, seed=0, vocab=VOCAB):
    """Token-level numpy batch with a sorted frame map (padding at the ends)."""
    r = np.random.RandomState(seed)
    txt = np.zeros((b, n_tokens), np.int64)
    txt[:, : n_tokens - 2] = r.randint(3, vocab, (b, n_tokens - 2))
    mel2ph = np.zeros((b, n_frames), np.int64)
    mel2ph[:, : n_frames - 4] = np.sort(r.randint(1, n_tokens - 1, (b, n_frames - 4)), axis=1)
    return dict(
        txt_tokens=txt,
        mel2ph=mel2ph,
        spk_ids=r.randint(0, 4, (b,)).astype(np.int64),
        pitch_midi=r.randint(50, 70, (b, n_tokens)).astype(np.int64),
        midi_dur=r.rand(b, n_tokens).astype(np.float32),
        is_slur=r.randint(0, 2, (b, n_tokens)).astype(np.int64),
        lang=r.randint(0, 2, (b, n_tokens)).astype(np.int64),
        speechsing=r.randint(0, 3, (b,)).astype(np.int64),
    )


def t(x):
    return torch.as_tensor(np.array(x))


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
