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


# an ARPAbet inventory: the phones of a TextGrid corpus (silences are "<SP>")
ARPABET = ["AA1", "AE1", "AH0", "B", "D", "EH1", "ER0", "F", "IY1", "K", "L", "M", "N",
           "OW1", "P", "R", "S", "T", "UW1", "Z"]
FRICATIVES = {"F", "S", "Z"}  # rendered as noise: unvoiced stretches inside speech


def write_textgrid_corpus(root, n_items, seed=0, sample_rate=22050, dur_range=(2.0, 4.0)):
    """An MFA-style speech corpus (the test copy of chip_smoke.py's writer):
    per item a 16-bit WAV, a TextGrid with a words tier and a phones tier
    (the last, which the aligner reads; silence intervals empty) and a line of
    `meta.json` {item_name, wav_fn, tg_fn, txt, ph, spk}. Words of 2-4 phones
    from `ARPABET`, silences at both ends and between some words; the audio
    is a harmonic voice whose f0 glides through 90-220 Hz, noise on the
    fricatives, near-silence in the pauses."""
    import json
    import os

    from scipy.io import wavfile

    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    meta = []
    for i in range(n_items):
        total = r.uniform(*dur_range)
        n_words = max(2, int(round((total - 0.45) / 0.31)))  # ~0.31 s a word
        words = [list(r.choice(ARPABET, r.randint(2, 5))) for _ in range(n_words)]
        pauses = [r.rand() < 0.3 for _ in range(n_words - 1)]
        # durations: phones ~ U(0.05, 0.12) s, pauses 0.1-0.25 s, edges 0.15-0.3 s
        segs = [("", r.uniform(0.15, 0.3))]
        for w, word in enumerate(words):
            segs += [(p, r.uniform(0.05, 0.12)) for p in word]
            if w < len(pauses) and pauses[w]:
                segs.append(("", r.uniform(0.1, 0.25)))
        segs.append(("", r.uniform(0.15, 0.3)))
        bounds = np.concatenate([[0.0], np.cumsum([d for _, d in segs])])
        dur = float(bounds[-1])
        n = int(round(dur * sample_rate))
        t = np.arange(n) / sample_rate
        f0 = (150 + 50 * np.sin(2 * np.pi * t / r.uniform(0.8, 1.6) + r.uniform(0, 6))
              + r.uniform(-20, 20))
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        voice = sum(np.sin(k * phase) / k for k in range(1, 11))
        noise = r.randn(n)
        wav = np.zeros(n)
        for (ph, _), a, b in zip(segs, bounds[:-1], bounds[1:]):
            lo, hi = int(round(a * sample_rate)), int(round(b * sample_rate))
            if ph == "":
                wav[lo:hi] = 1e-4 * noise[lo:hi]
            elif ph in FRICATIVES:
                wav[lo:hi] = 0.05 * noise[lo:hi]
            else:
                wav[lo:hi] = 0.2 * voice[lo:hi]
        name = f"LJ{i // 50 + 1:03d}-{i % 50 + 1:04d}"
        wav_fn = os.path.join(root, f"{name}.wav")
        wavfile.write(wav_fn, sample_rate, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        phone_tier = [(a, b, ph) for (ph, _), a, b in zip(segs, bounds[:-1], bounds[1:])]
        word_tier, k = [(0.0, bounds[1], "")], 1
        for w, word in enumerate(words):
            word_tier.append((bounds[k], bounds[k + len(word)], "w%d" % w))
            k += len(word)
            if segs[k][0] == "":
                word_tier.append((bounds[k], bounds[k + 1], ""))
                k += 1
        tg_fn = os.path.join(root, f"{name}.TextGrid")
        with open(tg_fn, "w") as f:
            f.write(textgrid_text(dur, [("words", word_tier), ("phones", phone_tier)]))
        ph = ["<SP>"]
        for w, word in enumerate(words):
            ph += word
            if w < len(pauses) and pauses[w]:
                ph.append("<SP>")
        ph.append("<SP>")
        meta.append(dict(item_name=name, wav_fn=wav_fn, tg_fn=tg_fn,
                         txt=" ".join("w%d" % w for w in range(len(words))), ph=" ".join(ph),
                         spk="LJSpeech"))
    with open(os.path.join(root, "meta.json"), "w") as f:
        for m in meta:
            f.write(json.dumps(m) + "\n")
    return meta


def textgrid_text(dur, tiers):
    """Praat's long TextGrid format for `tiers` [(name, [(xmin, xmax, text)])]."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {dur!r}", "tiers? <exists>", f"size = {len(tiers)}", "item []:"]
    for i, (name, ivs) in enumerate(tiers, 1):
        lines += [f"    item [{i}]:", '        class = "IntervalTier"',
                  f'        name = "{name}"', "        xmin = 0", f"        xmax = {dur!r}",
                  f"        intervals: size = {len(ivs)}"]
        for j, (a, b, text) in enumerate(ivs, 1):
            lines += [f"        intervals [{j}]:", f"            xmin = {float(a)!r}",
                      f"            xmax = {float(b)!r}", f'            text = "{text}"']
    return "\n".join(lines) + "\n"
