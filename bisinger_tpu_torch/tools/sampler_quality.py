"""The fast samplers against the DDPM-1000 chain (the port's counterpart of
`scripts/sampler_quality.py`).

    python -m bisinger_tpu_torch.tools.sampler_quality

One conditioner, one set of parameters and one start noise, sampled with
DDPM-1000 (the reference chain, x0 clipped at each step), PLMS-200 (the
production sampler, speedup 5, its x0 unclamped as the reference's) and
DPM-Solver++(2M) at 40 calls, every call of the DiffNet through K1 on the
card; reported: each fast sampler's mel MAE and mean SSIM against
DDPM-1000. Durations are predicted, as a request's are.

Two modes. By default a small DiffSingerMIDI (hidden 64, 10 x 64 DiffNet,
K1 at C = 64 on the card) is trained SQ_STEPS steps on a 24-item synthetic
corpus, SQ_FRAMES frames a bucket, in SQ_DTYPE (the port's knob:
`compute_dtype`, bfloat16 by default, or float32): the figures then
measure the samplers' agreement on a non-random denoiser, not audio
quality (PLMS can drift on an under-trained one).
SQ_CKPT=<an assets dir> (e.g. artifacts/flagship) samples its trained
model over the validation batch of SQ_DATA (a training run's dir with
raw/ and binary/, binarized from the synthetic corpus if missing), SQ_B
sentences, and adds each sampler's MAE against the ground-truth mel;
SQ_SAMPLERS picks them (ddpm always; dpmppN for N calls).

Knobs, as the JAX script's: SQ_PLATFORM (`cpu` for the CPU, else the card),
SQ_STEPS (400), SQ_FRAMES (256), SQ_CKPT, SQ_DATA (default
checkpoints/flagship_run), SQ_B (8), SQ_SAMPLERS (ddpm,plms,dpmpp). Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(f"[sq] {msg}", file=sys.stderr, flush=True)


def mel_mae(mel, ref, nonpad) -> float:
    """Mean |mel - ref| over the frames `nonpad` [B, T, 1] marks and every
    bin (`sampler_quality.py:152-154`)."""
    diff = np.abs(mel - ref) * nonpad
    return float(diff.sum() / (nonpad.sum() * ref.shape[-1]))


def mean_ssim(mel, ref) -> float:
    """The mean of the SSIM map of the loss (`training/losses.ssim`)."""
    from bisinger_tpu_torch.training.losses import ssim

    return float(ssim(torch.as_tensor(mel, dtype=torch.float32),
                      torch.as_tensor(ref, dtype=torch.float32)).mean())


def sampler_keys(sampler: str) -> dict:
    """ddpm: ancestral, 1000 calls; plms: speedup 5 (200 calls + warmup);
    dpmpp[N]: DPM-Solver++(2M) at N calls (40)."""
    if sampler == "plms":
        return dict(diff_sampler="plms", pndm_speedup=5)
    if sampler.startswith("dpmpp"):
        return dict(diff_sampler="dpmpp", dpm_steps=int(sampler[5:] or 40))
    return dict(diff_sampler="plms", pndm_speedup=0)


def nfe_of(sampler: str) -> int:
    if sampler == "ddpm":
        return 1000
    if sampler == "plms":
        return 200
    return int(sampler[5:] or 40)


def sample_all(model, vbatch, samplers, dev):
    """{sampler: mel} with durations predicted, each from a generator seeded
    1234 (one start noise; DDPM's step draws from it after the start)."""
    from bisinger_tpu_torch.training.tasks import model_kwargs

    kw = model_kwargs(vbatch, model.hp)  # as JAX's infer_step: no mel2ph, f0 or uv
    kw.update(mel2ph=None, f0=None, uv=None, max_frames=int(vbatch["mels"].shape[1]))
    mels = {}
    for sampler in samplers:
        m = copy.copy(model)
        m.hp = dict(model.hp, **sampler_keys(sampler))
        t0 = time.perf_counter()
        with torch.no_grad():
            mel = m(**kw, generator=torch.Generator(device=dev).manual_seed(1234))["mel_out"]
        mels[sampler] = mel.float().cpu().numpy()
        log(f"{sampler}: sampled in {time.perf_counter() - t0:.1f}s")
    return mels


def main() -> int:
    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.tools.card import device_of, emit

    full_fp32()
    dev = device_of(os.environ.get("SQ_PLATFORM", ""))
    ckpt = os.environ.get("SQ_CKPT", "")
    out = run_on_checkpoint(ckpt, dev) if ckpt else run_toy(dev)
    emit(out, dev)
    return 0


def run_toy(dev) -> dict:
    steps = int(os.environ.get("SQ_STEPS", 400))
    frames = int(os.environ.get("SQ_FRAMES", 256))
    with tempfile.TemporaryDirectory(prefix="sampler_quality_") as root:
        return _toy(dev, root, steps, frames)


def _toy(dev, root, steps, frames) -> dict:
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.data.binarizer import M4SingerBinarizer
    from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
    from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask

    make_synthetic_corpus(os.path.join(root, "raw"), n_items=24, seed=0)
    hp = make_hparams(dict(
        raw_data_dir=os.path.join(root, "raw"), raw_json_fn="meta.json",
        binary_data_dir=os.path.join(root, "binary"), test_prefixes=["Alto-1#song0"],
        hidden_size=64, enc_layers=2, dec_layers=2, num_heads=2, residual_layers=10,
        residual_channels=64, dilation_cycle_length=4, timesteps=1000, K_step=1000,
        schedule_type="linear", max_beta=0.02, gaussian_start=True, use_pitch_embed=False,
        num_spk=4, max_frames=frames, bucket_tokens=[48], bucket_frames=[frames],
        max_tokens=8000, lr=2e-4, compute_dtype=os.environ.get("SQ_DTYPE", "bfloat16"),
        **sampler_keys("plms")))
    M4SingerBinarizer(hp).process()
    it = iter(DataLoader(M4SingerDataset(hp, "train", shuffle=True), hp, shuffle=True,
                         endless=True))
    task = DiffSingerMIDITask(hp, 64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"training {steps} steps...")
    t0 = time.perf_counter()
    for i in range(steps):
        losses = task.train_step(batch_to_device(next(it), dev), gen)
        if i % 100 == 0:
            log(f"step {i}: mel={float(losses['mel']):.4f}")
    log(f"trained in {time.perf_counter() - t0:.1f}s")
    vbatch = batch_to_device(next(iter(DataLoader(M4SingerDataset(hp, "valid"), hp,
                                                  shuffle=False))), dev)
    mels = sample_all(task.model.eval(), vbatch, ("ddpm", "plms", "dpmpp"), dev)
    ref = mels["ddpm"]
    nonpad = (np.abs(ref).sum(-1, keepdims=True) > 1e-8).astype(np.float32)
    out = {"steps_trained": steps, "nfe": {"ddpm": 1000, "plms": 200, "dpmpp": 40}}
    for s in ("plms", "dpmpp"):
        out[s] = {"mel_mae_vs_ddpm1000": round(mel_mae(mels[s], ref, nonpad), 4),
                  "ssim_vs_ddpm1000": round(mean_ssim(mels[s], ref), 4)}
    return out


def run_on_checkpoint(ckpt: str, dev) -> dict:
    """Sampler agreement on a trained model (SQ_CKPT mode)."""
    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.data.binarizer import M4SingerBinarizer
    from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.utils.text_encoder import build_phone_encoder
    from bisinger_tpu_torch.weights import load_flax_params, load_npz

    data_root = os.path.abspath(os.environ.get(
        "SQ_DATA", os.path.join(REPO, "checkpoints", "flagship_run")))
    n = int(os.environ.get("SQ_B", 8))
    with open(os.path.join(ckpt, "hparams_diff.json")) as f:
        n_items = int(json.load(f).get("_n_items", 512))
    hp = load_hparams_json(os.path.join(ckpt, "hparams_diff.json"), dict(
        raw_data_dir=os.path.join(data_root, "raw"),
        binary_data_dir=os.path.join(data_root, "binary"),
        max_sentences=n, max_eval_sentences=n, **sampler_keys("plms")))
    if not os.path.exists(os.path.join(hp["binary_data_dir"], "phone_set.json")):
        log("the binarized corpus is missing: binarizing it (deterministic, seed 0)")
        if not os.path.exists(os.path.join(hp["raw_data_dir"], "meta.json")):
            make_synthetic_corpus(hp["raw_data_dir"], n_items=n_items, seed=0)
        M4SingerBinarizer(hp).process()
    vocab = build_phone_encoder(hp["binary_data_dir"]).vocab_size
    model = GaussianDiffusion(hp, vocab, hp["audio_num_mel_bins"])
    load_flax_params(model, load_npz(os.path.join(ckpt, "diff_params.npz")))
    model = model.to(dev).eval()
    val = next(iter(DataLoader(M4SingerDataset(hp, "valid", shuffle=False), hp, shuffle=False)))
    samplers = os.environ.get("SQ_SAMPLERS", "ddpm,plms,dpmpp").split(",")
    if "ddpm" not in samplers:
        samplers = ["ddpm"] + samplers
    mels = sample_all(model, batch_to_device(val, dev), samplers, dev)
    ref, gt = mels["ddpm"], val["mels"]
    nonpad = (val["mel2ph"] > 0)[:, :, None].astype(np.float32)
    out = {"ckpt": ckpt, "nfe": {s: nfe_of(s) for s in samplers},
           "gt_mae": {s: round(mel_mae(mels[s], gt, nonpad), 4) for s in samplers}}
    for s in samplers:
        if s != "ddpm":
            out[s] = {"mel_mae_vs_ddpm1000": round(mel_mae(mels[s], ref, nonpad), 4),
                      "ssim_vs_ddpm1000": round(mean_ssim(mels[s], ref), 4)}
    return out


if __name__ == "__main__":
    sys.exit(main())
