"""Each stage of the synthesis timed on its own (the port's counterpart of
`scripts/profile_split.py`).

    python -m bisinger_tpu_torch.tools.profile_split

The bench's graph with random weights at production size (hidden 256, 4 + 4
FFT layers, a 20 x 256 DiffNet through K1, K=1000 at PLMS speedup 5 or
DPM-Solver++, a 512-channel NSF HiFi-GAN through K2) on the bench batch
(`make_batch`, frame map given): the whole mel pipeline (conditioner and
sampler), the conditioner alone with its durations (its decoder input),
the PitchExtractor on the mel, and the vocoder. Each runs once, then 3
times, each call ended by a wait for the card; the sampler's time is the
whole pipeline's less the conditioner's. The ratio between stages is the
map of where to optimise; their sum is a little over one fused call.

Knobs, as the JAX script's: PS_PLATFORM (`cpu` for the CPU and a tiny
model: a 2 x 32 DiffNet, which K1 takes, but a 32-channel HiFi-GAN whose
MRF stages run at F = 16, 8, 4 and 2, and K2 takes F >= 8 only, so the
tiny model stays on the CPU; else the card), PS_B (32; 4 on the CPU), PS_T (1024; 64 on the CPU),
PS_SAMPLER (plms | dpmpp). Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import os
import sys

import torch

REPS = 3


def log(msg):
    print(f"[profile_split] {msg}", file=sys.stderr, flush=True)


def split_rows(t_full, t_cond, t_pe, t_voc, audio_s) -> dict:
    """Stage times in ms from seconds a call (`profile_split.py:160-170`)."""
    return {
        "full_mel_pipeline_ms": t_full * 1000,
        "fs2_conditioner_ms": t_cond * 1000,
        "diffusion_scan_ms_est": max(t_full - t_cond, 0.0) * 1000,
        "pe_ms": t_pe * 1000,
        "vocoder_nsf_ms": t_voc * 1000,
        "e2e_ms_sum": (t_full + t_pe + t_voc) * 1000,
        "audio_s_per_s_staged": audio_s / (t_full + t_pe + t_voc),
    }


def main() -> int:
    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.data.dataset import batch_to_device
    from bisinger_tpu_torch.inference.pipeline import make_batch
    from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
    from bisinger_tpu_torch.tools.card import clock, device_of, emit
    from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask, PitchExtractionTask
    from bisinger_tpu_torch.training.vocoder_task import flax_init_ as voc_init_

    full_fp32()
    dev = device_of(os.environ.get("PS_PLATFORM", ""))
    smoke = dev.type == "cpu"
    B = int(os.environ.get("PS_B", 4 if smoke else 32))
    T_MEL = int(os.environ.get("PS_T", 64 if smoke else 1024))
    T_TOK, VOCAB = (16 if smoke else 128), 64
    size = (dict(hidden_size=32, enc_layers=1, dec_layers=1, num_heads=2, residual_layers=2,
                 residual_channels=32, timesteps=8, K_step=8, pndm_speedup=2,
                 upsample_initial_channel=32)
            if smoke else
            dict(hidden_size=256, enc_layers=4, dec_layers=4, residual_layers=20,
                 residual_channels=256, dilation_cycle_length=4, timesteps=1000, K_step=1000,
                 schedule_type="linear", max_beta=0.02, pndm_speedup=5, gaussian_start=True,
                 upsample_initial_channel=512))
    hp = make_hparams(dict(use_pitch_embed=False, num_spk=21, max_frames=T_MEL,
                           bucket_tokens=[T_TOK], bucket_frames=[T_MEL],
                           upsample_rates=[8, 4, 2, 2], upsample_kernel_sizes=[16, 8, 4, 4],
                           diff_sampler=os.environ.get("PS_SAMPLER", "plms"), **size))
    batch = batch_to_device(make_batch(B, T_TOK, T_MEL, VOCAB, targets=True), dev)
    model = DiffSingerMIDITask(hp, VOCAB, device=dev).model.eval()
    pe = PitchExtractionTask(hp, device=dev).model.eval()
    voc = voc_init_(HifiGanGenerator(hp), 1).to(dev).eval()
    cond = {k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur", "lang", "speechsing")}
    gen = torch.Generator(device=dev).manual_seed(0)
    f0 = torch.full((B, T_MEL), 220.0, device=dev)

    def full():
        return model(batch["txt_tokens"], mel2ph=batch["mel2ph"], spk_id=batch["spk_ids"],
                     generator=gen, **cond)["mel_out"]

    def cond_only():  # the conditioner with its durations: the decoder input
        return model.fs2(batch["txt_tokens"], mel2ph=batch["mel2ph"], spk_id=batch["spk_ids"],
                         ref_mels=batch["mels"], skip_decoder=True, **cond)["decoder_inp"]

    def timeit(name, fn):
        t0 = clock(dev)
        fn()
        log(f"{name}: first call {clock(dev) - t0:.2f}s")
        total = 0.0
        for _ in range(REPS):
            t0 = clock(dev)
            fn()
            total += clock(dev) - t0
        return total / REPS

    with torch.no_grad():
        t_full = timeit("full_pipeline", full)
        mel = full()
        t_cond = timeit("fs2_conditioner", cond_only)
        t_pe = timeit("pe", lambda: pe(mel)["f0_denorm_pred"])
        t_voc = timeit("vocoder_nsf", lambda: voc(mel, f0, generator=gen))
    audio_s = B * T_MEL * hp["hop_size"] / hp["audio_sample_rate"]
    rows = split_rows(t_full, t_cond, t_pe, t_voc, audio_s)
    emit({"metric": "stage_split", "B": B, "T": T_MEL, "sampler": hp["diff_sampler"],
          **{k: round(v, 2) for k, v in rows.items()}}, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
