"""A miniature end-to-end convergence run (the port's counterpart of
`scripts/train_convergence.py`).

    python -m bisinger_tpu_torch.tools.train_convergence

Synthetic corpus -> binarize -> the FFT-Singer stage TC_STEPS steps -> the
PitchExtractor -> the shallow diffusion warm-started from stage 1 ->
teacher-forced sampling (the given durations; the DiffNet through K1 on
the card) -> the vocoder (through K2), through the port's trainer. It
reports the first-window against the last-window training losses of each
stage (the mean of the first and of the last five logged rows), the
teacher-forced mel MAE (and the PE's voiced f0 MAE in Hz) of the trained
model against its step-0 init, and writes a wav, the loss curves
(<TC_OUT>/curves_{fs2,pe,diff}.json) and summary.json. `converged` holds
when every signal moved far enough (TC_SMOKE=1: only the right way).

Knobs, as the JAX script's: TC_PLATFORM (`cpu` for the CPU, else the card),
TC_STEPS (2000), TC_ITEMS (64), TC_HIDDEN (64), TC_OUT (default
checkpoints/convergence), TC_VOC (a trained generator's dir; without it the
wav comes from a random generator, a plumbing artifact), TC_VOC_CHANNELS
(128), TC_SMOKE; and the port's TC_DTYPE (`compute_dtype`: bfloat16, the
default config's, or float32, K1's and K2's fp32 routes). At the default
TC_HIDDEN 64 the DiffNet is 10 x 64 and a TC_VOC_CHANNELS 128 vocoder's MRF
stages run at F = 64, 32, 16 and 8, all through the kernels on the card.
Prints the summary as one JSON line with the card's name and power limit;
exits 1 unless converged.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

# scripts/train_convergence.py:32-37 is the same function as train_flagship's
from bisinger_tpu_torch.tools.train_flagship import masked_mel_mae

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(f"[convergence] {msg}", file=sys.stderr, flush=True)


def window_avg(history, key, prefix="tr", first=True, k=5):
    """The mean of `key` over the first (or last) `k` rows of `prefix`."""
    rows = [h[key] for h in history if h["prefix"] == prefix and key in h]
    rows = rows[:k] if first else rows[-k:]
    return sum(rows) / max(len(rows), 1)


def history_of(trainer):
    """The trainer's logged rows as the JAX script records them: {"step",
    "prefix" ("tr" or "val"), **metrics}, in step order."""
    rows = [dict(step=s, prefix="tr", **m) for s, _, m in trainer.train_log]
    rows += [dict(step=s, prefix="val", **m) for s, m in trainer.val_log]
    return sorted(rows, key=lambda r: (r["step"], r["prefix"] == "val"))


def main() -> int:
    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.data.binarizer import M4SingerBinarizer
    from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
    from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
    from bisinger_tpu_torch.tools.card import card, device_of
    from bisinger_tpu_torch.training.tasks import (
        AuxDecoderMIDITask,
        DiffSingerMIDITask,
        PitchExtractionTask,
        model_kwargs,
    )
    from bisinger_tpu_torch.training.trainer import Trainer
    from bisinger_tpu_torch.training.vocoder_task import flax_init_ as voc_init_
    from bisinger_tpu_torch.utils.audio import save_wav
    from bisinger_tpu_torch.utils.pitch import denorm_f0
    from bisinger_tpu_torch.utils.text_encoder import build_phone_encoder
    from bisinger_tpu_torch.vocoders.hifigan import HifiGAN
    from bisinger_tpu_torch.weights import export_flax_params

    full_fp32()
    platform = os.environ.get("TC_PLATFORM", "")
    dev = device_of(platform)
    steps = int(os.environ.get("TC_STEPS", 2000))
    n_items = int(os.environ.get("TC_ITEMS", 64))
    hidden = int(os.environ.get("TC_HIDDEN", 64))
    out_dir = os.path.abspath(os.environ.get("TC_OUT", os.path.join(REPO, "checkpoints",
                                                                    "convergence")))
    os.makedirs(out_dir, exist_ok=True)
    raw = os.path.join(out_dir, "raw")
    if not os.path.exists(os.path.join(raw, "meta.json")):
        make_synthetic_corpus(raw, n_items=n_items, seed=0)
        log(f"synthetic corpus: {n_items} items under {raw}")
    base = dict(
        raw_data_dir=raw, raw_json_fn="meta.json",
        binary_data_dir=os.path.join(out_dir, "binary"), num_spk=4,
        test_prefixes=["Alto-1#song0"], pitch_extractor="autocorr",
        # small but real: enough capacity to visibly learn
        hidden_size=hidden, enc_layers=2, dec_layers=2, enc_ffn_kernel_size=9,
        dec_ffn_kernel_size=9, residual_layers=10, residual_channels=hidden, timesteps=100,
        K_step=100, max_beta=0.06, predictor_layers=2, dur_predictor_layers=2,
        use_pitch_embed=True, bucket_tokens=[16], bucket_frames=[768], max_tokens=5000,
        max_sentences=8, max_words=32, max_updates=steps, log_interval=max(steps // 40, 10),
        val_check_interval=max(steps // 4, 50), num_sanity_val_steps=1, num_ckpt_keep=1,
        warmup_updates=min(200, steps // 4),
        lr=1.0,  # the rsqrt scale of the fs2 stage; the diffusion stage sets its own
        clip_grad_norm=1.0, save_codes=False,
        compute_dtype=os.environ.get("TC_DTYPE", "bfloat16"))
    hp_fs2 = make_hparams(dict(base, work_dir=os.path.join(out_dir, "fs2")))
    if not os.path.exists(os.path.join(hp_fs2["binary_data_dir"], "phone_set.json")):
        M4SingerBinarizer(hp_fs2).process()
        log("binarized")
    vocab = build_phone_encoder(hp_fs2["binary_data_dir"]).vocab_size
    val_batch = next(iter(DataLoader(M4SingerDataset(hp_fs2, "valid"), hp_fs2,
                                     shuffle=False)))
    vb = batch_to_device(val_batch, dev)
    summary = {"steps": steps, "n_items": n_items, "hidden": hidden, "platform": str(dev)}

    def fit(task, hp):
        tr = Trainer(task, hp, hp["work_dir"])
        tr.fit()
        return tr, history_of(tr)

    def dump(name, history):
        with open(os.path.join(out_dir, f"curves_{name}.json"), "w") as f:
            json.dump(history, f)

    # ---- stage 1: FFT-Singer ----
    t0 = time.time()
    task1 = AuxDecoderMIDITask(hp_fs2, vocab, device=dev)

    def teacher_forced_mae():  # the given durations and f0
        task1.model.eval()
        with torch.no_grad():
            mel = task1.forward(vb)["mel_out"].float().cpu().numpy()
        return masked_mel_mae(mel, val_batch["mels"], val_batch["mel2ph"])

    mae_fs2_0 = teacher_forced_mae()
    _, hist1 = fit(task1, hp_fs2)
    summary["fs2"] = {
        "total_loss_first": window_avg(hist1, "total_loss", first=True),
        "total_loss_last": window_avg(hist1, "total_loss", first=False),
        "l1_first": window_avg(hist1, "l1", first=True),
        "l1_last": window_avg(hist1, "l1", first=False),
        "teacher_forced_mae_step0": mae_fs2_0,
        "teacher_forced_mae_final": teacher_forced_mae(),
        "wall_s": round(time.time() - t0, 1),
    }
    dump("fs2", hist1)
    log(f"fs2 stage: {summary['fs2']}")

    # ---- stage 1.5: the PitchExtractor, voiced f0 MAE in Hz ----
    t0 = time.time()
    hp_pe = make_hparams(dict(base, work_dir=os.path.join(out_dir, "pe")))
    task_pe = PitchExtractionTask(hp_pe, device=dev)

    def pe_f0_mae():
        pred = task_pe.infer_step(vb["mels"])["f0_denorm_pred"].float().cpu().numpy()
        gt = denorm_f0(vb["f0"], vb["uv"], hp_pe["pitch_norm"], use_uv=hp_pe["use_uv"])
        voiced = (val_batch["uv"] == 0) & (val_batch["mel2ph"] > 0)
        return float(np.abs(pred - gt.float().cpu().numpy())[voiced].mean())

    mae_pe_0 = pe_f0_mae()
    _, hist_pe = fit(task_pe, hp_pe)
    summary["pe"] = {
        "total_loss_first": window_avg(hist_pe, "total_loss", first=True),
        "total_loss_last": window_avg(hist_pe, "total_loss", first=False),
        "val_f0_mae_hz_step0": mae_pe_0,
        "val_f0_mae_hz_final": pe_f0_mae(),
        "wall_s": round(time.time() - t0, 1),
    }
    dump("pe", hist_pe)
    log(f"pe stage: {summary['pe']}")

    # ---- stage 2: shallow diffusion, warm-started from stage 1 ----
    t0 = time.time()
    hp_diff = make_hparams(dict(base, work_dir=os.path.join(out_dir, "diff"),
                                fs2_ckpt=os.path.join(out_dir, "fs2"), lr=1e-3,
                                decay_steps=max(steps // 2, 100)))
    task2 = DiffSingerMIDITask(hp_diff, vocab, device=dev)

    def sample_teacher_forced():
        """Shallow-diffusion sampling on the given durations and f0."""
        task2.model.eval()
        with torch.no_grad():
            ret = task2.model(**model_kwargs(vb, hp_diff),
                              generator=torch.Generator(device=dev).manual_seed(7))
        return masked_mel_mae(ret["mel_out"].float().cpu().numpy(), val_batch["mels"],
                              val_batch["mel2ph"])

    mae_diff_0 = sample_teacher_forced()
    _, hist2 = fit(task2, hp_diff)
    summary["diffusion"] = {
        "mel_first": window_avg(hist2, "mel", first=True),
        "mel_last": window_avg(hist2, "mel", first=False),
        "sampled_mae_step0": mae_diff_0,
        "sampled_mae_final": sample_teacher_forced(),
        "wall_s": round(time.time() - t0, 1),
    }
    dump("diff", hist2)
    log(f"diffusion stage: {summary['diffusion']}")

    # ---- stage 3: vocode the first sampled mel (durations predicted), its bucket whole ----
    voc_dir = os.environ.get("TC_VOC", "")
    if voc_dir:
        voc = HifiGAN(dict(hp_diff, vocoder_ckpt=voc_dir, upsample_initial_channel=int(
            os.environ.get("TC_VOC_CHANNELS", 128))), device=dev)
    else:  # a random generator: the wav is a plumbing artifact
        voc = HifiGAN(hp_diff, params=export_flax_params(
            voc_init_(HifiGanGenerator(hp_diff), 0)), device=dev)
    kw = model_kwargs(vb, hp_diff)
    kw.update(mel2ph=None, f0=None, uv=None, max_frames=int(val_batch["mels"].shape[1]))
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(3)
        ret = task2.model(**kw, generator=gen)
        f0 = ret["f0_denorm"] if "f0_denorm" in ret else vb["f0"]
        wav = voc.generate(ret["mel_out"][:1], f0[:1], gen)[0].float().cpu().numpy()
    wav_path = os.path.join(out_dir, "sample.wav")
    save_wav(wav, wav_path, hp_diff["audio_sample_rate"])
    summary["wav"] = wav_path
    summary["wav_vocoder_trained"] = bool(voc_dir)
    log(f"vocoded sample -> {wav_path}" + ("" if voc_dir else
                                           " (an untrained vocoder: plumbing, not quality)"))

    # The bars: the fs2 losses should collapse; the diffusion loss has a high
    # floor (the denoiser predicts unit noise, most of it irreducible at large
    # t), so a 15% drop is material there and its sampled MAE is the quality
    # signal. TC_SMOKE=1 asks only that every signal move the right way.
    smoke = os.environ.get("TC_SMOKE") == "1"
    f_loss, f_mae, d_loss, d_mae, p_loss, p_mae = (
        (0.995, 0.995, 0.999, 0.98, 0.995, 0.995) if smoke else (0.7, 0.8, 0.85, 0.8, 0.8, 0.8))
    fs2, diff, pe = summary["fs2"], summary["diffusion"], summary["pe"]
    summary["converged"] = bool(
        fs2["total_loss_last"] < f_loss * fs2["total_loss_first"]
        and fs2["teacher_forced_mae_final"] < f_mae * fs2["teacher_forced_mae_step0"]
        and diff["mel_last"] < d_loss * diff["mel_first"]
        and diff["sampled_mae_final"] < d_mae * diff["sampled_mae_step0"]
        and pe["total_loss_last"] < p_loss * pe["total_loss_first"]
        and pe["val_f0_mae_hz_final"] < p_mae * pe["val_f0_mae_hz_step0"])
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({**summary, **card(dev)}), flush=True)
    return 0 if summary["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
