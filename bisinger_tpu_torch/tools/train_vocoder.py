"""Train the HiFi-GAN vocoder (the GAN task, `training/vocoder_task.py`)
on synthetic harmonic audio, then round-trip the generator through the
inference wrapper (the port's counterpart of `scripts/train_vocoder.py`).

    python -m bisinger_tpu_torch.tools.train_vocoder [--device cpu]

Settings come from the environment, as the JAX script reads them:
TV_STEPS (400), TV_BATCH (4), TV_FRAMES (32), TV_CHANNELS (64),
TV_MULTIBAND (1; 4 trains the PQMF fast mode: upsample rates [8, 4],
kernels [16, 8], 4 subbands), TV_OUT (a directory), TV_IMPROVE (0.7),
TV_DMIN (0.05), TV_DMAX (8.0), and TV_CONFIG: a config (YAML or JSON, as
`run --config` takes it) whose keys replace the defaults under the
overrides above, e.g. configs/tts/hifigan.yaml for the TTS configs' plain
HiFi-GAN (22.05 kHz, hop 256, rates [8, 8, 2, 2], no NSF source). The
flagship recipe runs TV_BATCH=8 TV_FRAMES=64 TV_CHANNELS=512.
compute_dtype is the default bfloat16 (the discriminators and conv_post are
fp32).

The clips are rendered notes (`data/synthetic.render_notes`) with their
f0 exact per frame; each step samples random windows of TV_FRAMES frames.
Writes `<TV_OUT>/vocoder/generator_{steps:09d}.npz` (plain kernels, flax
names), loads it through `vocoders/hifigan.HifiGAN` and vocodes a
held-out mel with it and with the initial generator. Prints one JSON
summary; `ok` needs finite losses, gen_mel below TV_IMPROVE x its first
value, disc_loss in (TV_DMIN, TV_DMAX), and the trained generator's mel
L1 under the initial one's. Exit code 0 when ok.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from bisinger_tpu_torch import full_fp32


def log(msg):
    print(f"[train_vocoder] {msg}", file=sys.stderr, flush=True)


def build_windows(hp, n_clips, frames, rng):
    """Synthetic harmonic clips -> [(mel [T, 80], f0 [T], wav [T * hop])],
    f0 exact per frame from the note grid; each clip covers at least one
    window of `frames` frames."""
    from bisinger_tpu_torch.data.synthetic import midi_to_hz, render_notes
    from bisinger_tpu_torch.utils.audio import wav2spec

    sr, hop = hp["audio_sample_rate"], hp["hop_size"]
    min_sec = (frames + 2) * hop / sr
    clips = []
    for _ in range(n_clips):
        n_notes = rng.randint(4, 8)
        notes = np.clip(60 + np.cumsum(rng.randint(-3, 4, n_notes)), 50, 75)
        durs = rng.uniform(0.15, 0.4, n_notes)
        if durs.sum() < min_sec:
            durs = durs * (min_sec / durs.sum())
        wav = render_notes(list(notes), list(durs), sr, rng)
        wav_pad, mel = wav2spec(wav, sr, hp["fft_size"], hop, hp["win_size"],
                                hp["audio_num_mel_bins"], hp["fmin"], hp["fmax"])
        f0 = np.zeros(mel.shape[0], np.float32)
        pos = 0.0
        for note, dur in zip(notes, durs):
            a, b = int(pos * sr / hop), int((pos + dur) * sr / hop)
            f0[a: min(b, len(f0))] = midi_to_hz(note)
            pos += dur
        clips.append((mel.astype(np.float32), f0, wav_pad.astype(np.float32)))
    return clips


def sample_batch(clips, batch, frames, hop, rng):
    mels, f0s, wavs = [], [], []
    for _ in range(batch):
        mel, f0, wav = clips[rng.randint(len(clips))]
        start = rng.randint(max(mel.shape[0] - frames, 1))
        mels.append(mel[start: start + frames])
        f0s.append(f0[start: start + frames])
        wavs.append(wav[start * hop: (start + frames) * hop])
    return {"mels": np.stack(mels), "f0": np.stack(f0s), "wav": np.stack(wavs)}


def settings():
    env = os.environ.get
    return dict(steps=int(env("TV_STEPS", 400)), batch=int(env("TV_BATCH", 4)),
                frames=int(env("TV_FRAMES", 32)), channels=int(env("TV_CHANNELS", 64)),
                multiband=int(env("TV_MULTIBAND", 1)),
                out_dir=os.path.abspath(env("TV_OUT", "vocoder_run")),
                improve=float(env("TV_IMPROVE", 0.7)), d_min=float(env("TV_DMIN", 0.05)),
                d_max=float(env("TV_DMAX", 8.0)), config=env("TV_CONFIG", ""))


def vocoder_hparams(channels: int, multiband: int, ckpt_dir: str, config: str = ""):
    """The defaults, or `config`'s hyperparameters, with the script's
    overrides."""
    from bisinger_tpu_torch.config import load_hparams, make_hparams

    over = dict(upsample_initial_channel=channels, vocoder_ckpt=ckpt_dir)
    if multiband > 1:
        over.update(vocoder_multiband=multiband, upsample_rates=[8, 4],
                    upsample_kernel_sizes=[16, 8])
    return load_hparams(config, over) if config else make_hparams(over)


def run(cfg: dict, device=None, on_step=None) -> dict:
    """The GAN loop and the round trip; returns the summary. `on_step(step,
    metrics)` is called after each train step."""
    from bisinger_tpu_torch.data.dataset import batch_to_device
    from bisinger_tpu_torch.training.vocoder_task import HifiGanTask
    from bisinger_tpu_torch.utils.audio import save_wav, wav2spec
    from bisinger_tpu_torch.vocoders.hifigan import HifiGAN

    out_dir = cfg["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    hp = vocoder_hparams(cfg["channels"], cfg["multiband"], os.path.join(out_dir, "vocoder"),
                         cfg.get("config", ""))
    steps, batch, frames = cfg["steps"], cfg["batch"], cfg["frames"]
    rng_np = np.random.RandomState(0)
    clips = build_windows(hp, n_clips=12, frames=frames, rng=rng_np)
    log(f"{len(clips)} synthetic clips")
    task = HifiGanTask(hp, device=device, seed=0)
    dev = task.device
    init_gen = task.export_gen_params()
    gen = torch.Generator(device=dev).manual_seed(1)
    history, t_first = [], None
    for step in range(1, steps + 1):
        b = batch_to_device(sample_batch(clips, batch, frames, hp["hop_size"], rng_np), dev)
        metrics = task.train_step(b, gen)
        if on_step is not None:
            on_step(step, metrics)
        if step == 1:
            metrics = {k: float(v) for k, v in metrics.items()}  # sync: the first step apart
            t_first = time.perf_counter()
        if step % max(steps // 20, 1) == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
            log(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())
                                            if k != "step"))
            if not all(np.isfinite(v) for v in m.values()):
                log("NaN/Inf detected: aborting")
                return {"ok": False, "history": history}
    steps_per_s = (steps - 1) / max(time.perf_counter() - t_first, 1e-9)

    ckpt_dir = hp["vocoder_ckpt"]
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(os.path.join(ckpt_dir, f"generator_{steps:09d}.npz"), **task.export_gen_params())
    voc = HifiGAN(hp, device=dev)  # the newest generator_*.npz, or it raises
    mel, f0, _ = clips[0]
    t_eval = min(mel.shape[0], 128)
    wav_trained = voc.spec2wav(mel[:t_eval], f0[:t_eval])
    wav_init = HifiGAN(hp, params=init_gen, device=dev).spec2wav(mel[:t_eval], f0[:t_eval])

    def mel_l1_of(wav_out):
        n = min(len(wav_out), t_eval * hp["hop_size"])
        _, m = wav2spec(np.asarray(wav_out[:n], np.float32), hp["audio_sample_rate"],
                        hp["fft_size"], hp["hop_size"], hp["win_size"],
                        hp["audio_num_mel_bins"], hp["fmin"], hp["fmax"])
        t = min(m.shape[0], t_eval)
        return float(np.abs(m[:t] - mel[:t]).mean())

    mel_l1_trained, mel_l1_init = mel_l1_of(wav_trained), mel_l1_of(wav_init)
    save_wav(wav_trained, os.path.join(out_dir, "vocoded.wav"), hp["audio_sample_rate"])
    first, last = history[0], history[-1]
    summary = {
        "steps": steps, "steps_per_s": round(steps_per_s, 3), "batch": batch,
        "frames": frames, "gen_mel_first": first["gen_mel"], "gen_mel_last": last["gen_mel"],
        "disc_loss_first": first["disc_loss"], "disc_loss_last": last["disc_loss"],
        "mel_l1_vocoded_init": mel_l1_init, "mel_l1_vocoded_trained": mel_l1_trained,
        "ok": bool(np.isfinite([v for h in history for v in h.values()]).all()
                   and last["gen_mel"] < cfg["improve"] * first["gen_mel"]
                   and cfg["d_min"] < last["disc_loss"] < cfg["d_max"]
                   and mel_l1_trained < mel_l1_init),
    }
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(history, f)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to ask for it")
    args = ap.parse_args(argv)
    full_fp32()
    summary = run(settings(), device=args.device)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
