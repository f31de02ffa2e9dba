"""Token-level requests -> waveforms on one device
(counterpart of `bisinger_tpu/inference/pipeline.py:157-313`, the fused
synth of `_make_fused_synth`, and of bench.py's `synth`).

A request is a dict of per-token arrays (`ph_token`, `pitch_midi`,
`midi_dur`, `is_slur`, `lang`) plus `spk_id` and `speechsing`, and may
carry a frame map `mel2ph`; `items_to_batch` pads requests into one batch
and `synthesize` runs

    FastSpeech2MIDI -> PLMS diffusion (DiffNet through K1) -> mel
    -> PitchExtractor f0 -> NSF HiFi-GAN (MRF stages through K2) -> wav.

The score front end (text -> tokens) stays on the JAX side for now.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bisinger_tpu_torch import resolve_device
from bisinger_tpu_torch.config import load_hparams_json
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.weights import load_flax_params, load_npz

FLAGSHIP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "flagship")


def make_batch(b: int, n_tokens: int, n_frames: int, vocab: int = 32, seed: int = 0
               ) -> Dict[str, np.ndarray]:
    """Random token-level batch with a frame map, drawn as bench.py draws its
    batch (the port's own copy of `__graft_entry__._batch`, inference keys)."""
    r = np.random.RandomState(seed)
    txt = np.zeros((b, n_tokens), np.int64)
    txt[:, : n_tokens - 2] = r.randint(3, vocab, (b, n_tokens - 2))
    mel2ph = np.zeros((b, n_frames), np.int64)
    mel2ph[:, : n_frames - 8] = np.sort(r.randint(1, n_tokens - 2, (b, n_frames - 8)), axis=1)
    spk_ids = r.randint(0, 4, (b,)).astype(np.int64)
    # mels, f0 and uv are training targets: drawn only to keep the same stream
    r.randn(b, n_frames, 80)
    r.rand(b, n_frames)
    r.rand(b, n_frames)
    pitch_midi = r.randint(50, 70, (b, n_tokens)).astype(np.int64)
    midi_dur = r.rand(b, n_tokens).astype(np.float32)
    is_slur = r.randint(0, 2, (b, n_tokens)).astype(np.int64)
    r.randint(0, 2, (b, n_tokens))  # word_boundary, a training input
    lang = r.randint(0, 2, (b, n_tokens)).astype(np.int64)
    return dict(txt_tokens=txt, mel2ph=mel2ph, spk_ids=spk_ids, pitch_midi=pitch_midi,
                midi_dur=midi_dur, is_slur=is_slur, lang=lang,
                speechsing=np.ones((b,), np.int64))


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class SVSInferTorch:
    """The flagship's inference path on one device. Build it with
    `from_checkpoint` (the flagship npz files) or from modules."""

    def __init__(self, hp: dict, model: GaussianDiffusion, pe: PitchExtractor,
                 vocoder: HifiGanGenerator, device=None):
        self.device = resolve_device(device)
        self.hp = hp
        self.model = model.to(self.device).eval()
        self.pe = pe.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str = FLAGSHIP_DIR, device=None,
                        hp_overrides: Optional[dict] = None) -> "SVSInferTorch":
        """diff_params.npz (fs2 + DiffNet), pe_params.npz + pe_batch_stats.npz,
        and the newest vocoder/**/generator_*.npz of a trained run."""
        hp = load_hparams_json(os.path.join(ckpt_dir, "hparams_diff.json"), hp_overrides)
        flat = load_npz(os.path.join(ckpt_dir, "diff_params.npz"))
        vocab = int(flat["fs2/token_embed/embed/embedding"].shape[0])
        model = GaussianDiffusion(hp, vocab, hp["audio_num_mel_bins"])
        load_flax_params(model, flat)
        stats_fn = os.path.join(ckpt_dir, "pe_batch_stats.npz")
        if not os.path.exists(stats_fn):
            raise FileNotFoundError(f"{stats_fn} is missing: the PE's BatchNorm needs its "
                                    "running statistics")
        pe = PitchExtractor(hp)
        load_flax_params(pe, {**load_npz(os.path.join(ckpt_dir, "pe_params.npz")),
                              **load_npz(stats_fn)})
        cands = sorted(glob.glob(os.path.join(ckpt_dir, "vocoder", "**", "generator_*.npz"),
                                 recursive=True))
        if not cands:
            raise FileNotFoundError(f"no vocoder/**/generator_*.npz under {ckpt_dir}")
        vocoder = HifiGanGenerator(hp)
        load_flax_params(vocoder, load_npz(cands[-1]))
        return cls(hp, model, pe, vocoder, device)

    @property
    def vocab_size(self) -> int:
        return self.model.fs2.token_embed.embed.num_embeddings

    def items_to_batch(self, items: List[Dict[str, Any]], t_txt: Optional[int] = None,
                       t_mel: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Pad requests to one batch. Token and frame lengths default to the
        configured buckets; a batch either gives every request's `mel2ph`
        or none (then durations are predicted within `t_mel` frames)."""
        hp = self.hp
        t_txt = t_txt or pick_bucket(max(len(it["ph_token"]) for it in items),
                                     hp["bucket_tokens"])
        given = [it.get("mel2ph") is not None for it in items]
        if any(given) and not all(given):
            raise ValueError("give mel2ph for every request of a batch or for none")
        if t_mel is None:
            if all(given):
                frames = [len(it["mel2ph"]) for it in items]
            else:  # the score's duration, as the reference's items_to_batch budgets it
                frames = [int(float(np.sum(it["midi_dur"])) * hp["audio_sample_rate"]
                              / hp["hop_size"]) + 8 for it in items]
            t_mel = pick_bucket(max(frames), hp["bucket_frames"])

        def pad(key, dtype, width):
            out = np.zeros((len(items), width), dtype)
            for i, it in enumerate(items):
                x = np.asarray(it[key])[:width]
                out[i, : len(x)] = x
            return out

        batch = {
            "txt_tokens": pad("ph_token", np.int64, t_txt),
            "pitch_midi": pad("pitch_midi", np.int64, t_txt),
            "midi_dur": pad("midi_dur", np.float32, t_txt),
            "is_slur": pad("is_slur", np.int64, t_txt),
            "lang": pad("lang", np.int64, t_txt),
            "spk_ids": np.asarray([it["spk_id"] for it in items], np.int64),
            "speechsing": np.asarray([it.get("speechsing", 1) for it in items], np.int64),
            "n_frames": t_mel,
        }
        if all(given):
            batch["mel2ph"] = pad("mel2ph", np.int64, t_mel)
        return batch

    @torch.no_grad()
    def synthesize(self, batch: Dict[str, Any], start_noise=None, nsf_phase=None,
                   nsf_noise=None, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One batch -> {"wav" [B, T*hop], "mel" [B, T, 80], "f0" [B, T],
        "mel2ph" [B, T]}. Random draws (diffusion start, NSF phase and
        noise) come from `generator` unless given."""
        dev = self.device
        as_t = lambda k: torch.as_tensor(batch[k], device=dev)  # noqa: E731
        mel2ph = batch.get("mel2ph")
        ret = self.model(
            as_t("txt_tokens"),
            mel2ph=None if mel2ph is None else torch.as_tensor(mel2ph, device=dev),
            spk_id=as_t("spk_ids"), pitch_midi=as_t("pitch_midi"), midi_dur=as_t("midi_dur"),
            is_slur=as_t("is_slur"), lang=as_t("lang"), speechsing=as_t("speechsing"),
            max_frames=batch.get("n_frames") if mel2ph is None else None,
            start_noise=start_noise, generator=generator,
        )
        mel = ret["mel_out"]
        f0 = self.pe(mel)["f0_denorm_pred"]
        wav = self.vocoder(mel, f0, phase=nsf_phase, noise=nsf_noise, generator=generator)
        return {"wav": wav, "mel": mel, "f0": f0, "mel2ph": ret["mel2ph"]}
