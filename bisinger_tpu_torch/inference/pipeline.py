"""Scores -> waveforms on one device (counterpart of
`bisinger_tpu/inference/pipeline.py`: `SVSInfer` with its fused synth,
and bench.py's `synth`).

A score is a dict as the JAX package takes it (`text`, `notes`,
`notes_duration`, optional `spk_name`, `bpm`, or the phoneme-level keys);
`infer_once`, `infer_batch` and `infer_from_json` put scores through the
bilingual front end (`data/text/frontend.py`) into items: per-token
arrays (`ph_token`, `pitch_midi`, `midi_dur`, `is_slur`, `lang`) plus
`spk_id`, `speechsing` and `total_sec`. An item made by hand may instead
carry a frame map `mel2ph`. A model conditioned on speaker vectors
(`use_spk_embed`) takes each score's `spk_embed` (256 floats), else zeros;
the port's `score_items` carries the key from the score into its item (JAX's
front end drops it, so JAX serves a score with zeros; ROADMAP Queue 3).
`items_to_batch` pads items into one batch at the configured buckets, and
`synthesize` runs

    FastSpeech2MIDI or FastSpeech2 (`use_midi`) -> diffusion sampler
    (DiffNet through K1) -> mel -> f0 -> vocoder -> wav,

or, for a work dir of the FFT-Singer stage (`AuxDecoderMIDITask`, alias
`FastSpeech2Task`), the conditioner's own decoder mel in place of the
diffusion's, as JAX's `AuxDecoderMIDITask.infer_step` returns it
(`bisinger_tpu/training/tasks.py:191-202`): no sampler, no K1 launch.

The vocoder is the class the vocoder's own hyperparameters name
(`vocoder`, through `vocoders/base_vocoder.get_vocoder_cls`): a HiFi-GAN
(ResBlock1 stages through K2, ResBlock2 stages as layers; PQMF synthesis
when multiband, `vocoder_multiband`) or a Parallel WaveGAN (noise z of
T * hop samples drawn from the call's generator, no f0). The f0 is the
PitchExtractor's when the pipeline has one (the flagship's; for a work dir
with `pe_enable`, the newest checkpoint of the run `pe_ckpt` names), else
the acoustic model's own `f0_denorm` (a pitch-conditioned FastSpeech2's:
frame, phone or CWT pitch), else zeros
(`bisinger_tpu/inference/pipeline.py:253-259`). A HiFi-GAN is handed the
f0 only when it was built with `use_nsf` (`pipeline.py:248-268`); the plain
HiFi-GAN of the TTS configs takes none.

Long-form synthesis (`sequence_parallel_axis`, `parallel/sequence.py`):
on the ranks of an entered ('data', 'seq') mesh, every rank calls
`synthesize` with the same global batch; each keeps its rows, runs the
conditioner whole, and the sampler, the PE and the vocoder on its frames
widened by their halos, and returns its rows' core frames (mel, f0,
mel2ph) and their samples (wav); the pins are given at the global shape.
`infer_batch` gathers every rank's part, so each rank returns all
waveforms.

Tensor parallelism (`parallel/tensor.py`): on the ranks of an entered
('data', 'model') mesh (`with tensor.make_mesh(num_data=1, num_model=n):`)
every rank calls `synthesize` with the same batch and a generator seeded
alike; the DiffNet, the PE and the NSF HiFi-GAN run as the rank's share of
their sharded layers (views built once per mesh, `shard_for_tp`), the rest
replicated, and every rank returns the whole result. The DiffNet runs its
layer path and the MRF its layers: a TP rank launches no K1 and no K2.

The score entry points trim each waveform to its filled frames; with the
vocoder's `use_denoise` each waveform of the batch is first denoised on the
host (`BaseVocoder.postprocess`), as JAX's `spec2wav_batch` does. The
JAX package's fused path cannot serve a PWG, and its `run --infer` builds a
HiFi-GAN whatever `vocoder` says; the port serves the class named
(ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bisinger_tpu_torch import resolve_device
from bisinger_tpu_torch.config import apply_overrides, load_hparams_json
from bisinger_tpu_torch.data.text.frontend import BilingualFrontend
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.parallel import sequence, tensor
from bisinger_tpu_torch.utils.audio import save_wav
from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder, build_phone_encoder
from bisinger_tpu_torch.vocoders.base_vocoder import as_vocoder, get_vocoder_cls, latest_generator
from bisinger_tpu_torch.weights import load_flax_params, load_npz

FLAGSHIP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "flagship")
JSON_GROUP = 8  # scores a batch in infer_from_json (the JAX default batch_size)


def make_batch(b: int, n_tokens: int, n_frames: int, vocab: int = 32, seed: int = 0,
               targets: bool = False) -> Dict[str, np.ndarray]:
    """Random token-level batch with a frame map, drawn as bench.py draws its
    batch (the port's own copy of `__graft_entry__._batch`): the inference
    keys, and with `targets` the training ones too (mels, f0, uv,
    word_boundary)."""
    r = np.random.RandomState(seed)
    txt = np.zeros((b, n_tokens), np.int64)
    txt[:, : n_tokens - 2] = r.randint(3, vocab, (b, n_tokens - 2))
    mel2ph = np.zeros((b, n_frames), np.int64)
    mel2ph[:, : n_frames - 8] = np.sort(r.randint(1, n_tokens - 2, (b, n_frames - 8)), axis=1)
    spk_ids = r.randint(0, 4, (b,)).astype(np.int64)
    # the training targets are drawn either way, to keep the same stream
    train = dict(mels=r.randn(b, n_frames, 80).astype(np.float32),
                 f0=(r.rand(b, n_frames) * 2 + 5).astype(np.float32),
                 uv=(r.rand(b, n_frames) > 0.8).astype(np.float32))
    pitch_midi = r.randint(50, 70, (b, n_tokens)).astype(np.int64)
    midi_dur = r.rand(b, n_tokens).astype(np.float32)
    is_slur = r.randint(0, 2, (b, n_tokens)).astype(np.int64)
    train["word_boundary"] = r.randint(0, 2, (b, n_tokens)).astype(np.int64)
    lang = r.randint(0, 2, (b, n_tokens)).astype(np.int64)
    return dict(txt_tokens=txt, mel2ph=mel2ph, spk_ids=spk_ids, pitch_midi=pitch_midi,
                midi_dur=midi_dur, is_slur=is_slur, lang=lang,
                speechsing=np.ones((b,), np.int64), **(train if targets else {}))


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pe_and_vocoder(ckpt_dir: str, hp: dict, with_pe: bool = True):
    """The PitchExtractor (pe_params.npz + pe_batch_stats.npz; None unless
    `with_pe`) and the generator module of the class `hp["vocoder"]` names,
    loaded from the highest step among vocoder/**/generator_*.npz of a
    trained run's directory (vocoder_mb<n>/** for an n-band vocoder, as
    bench.py reads them)."""
    pe = None
    if with_pe:
        stats_fn = os.path.join(ckpt_dir, "pe_batch_stats.npz")
        if not os.path.exists(stats_fn):
            raise FileNotFoundError(f"{stats_fn} is missing: the PE's BatchNorm needs its "
                                    "running statistics")
        pe = PitchExtractor(hp)
        load_flax_params(pe, {**load_npz(os.path.join(ckpt_dir, "pe_params.npz")),
                              **load_npz(stats_fn)})
    n = int(hp.get("vocoder_multiband", 1) or 1)
    sub = f"vocoder_mb{n}" if n > 1 else "vocoder"
    path = latest_generator(os.path.join(ckpt_dir, sub), recursive=True)
    if path is None:
        raise FileNotFoundError(f"no {sub}/**/generator_*.npz under {ckpt_dir}")
    vocoder = get_vocoder_cls(hp).MODEL(hp)
    load_flax_params(vocoder, load_npz(path))
    return pe, vocoder


def pe_from_run(hp: dict) -> Optional[PitchExtractor]:
    """The PitchExtractor a work dir serves with, by JAX's rule
    (`bisinger_tpu/inference/pipeline.py:104-130`): with `pe_enable`, the
    newest checkpoint under `<pe_ckpt>/ckpt` (a `PitchExtractionTask` run of
    the port, its BatchNorm running statistics among the parameters), loaded
    into a PE built from the serving run's `hp`, as JAX and the reference
    build it; with no such checkpoint a warning and None, so that f0 is the
    model's own. None without `pe_enable`."""
    if not hp.get("pe_enable"):
        return None
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager

    pe_dir = hp.get("pe_ckpt") or ""
    ckpt_dir = os.path.join(pe_dir, "ckpt")
    restored = (CheckpointManager(ckpt_dir).restore()
                if pe_dir and os.path.isdir(ckpt_dir) else None)
    if restored is None:
        print(f"| WARNING: pe_enable set but no PE checkpoint under {pe_dir!r}; falling back "
              "to the model's own f0", flush=True)
        return None
    pe = PitchExtractor(hp)
    load_flax_params(pe, restored["params"])
    return pe


class SVSInferTorch:
    """The flagship's inference path on one device. Build it with
    `from_checkpoint` (the flagship's files), `from_work_dir` (a training
    run's) or from modules: `model` a `GaussianDiffusion`, or a
    FastSpeech2(MIDI) whose decoder's mel is served; the score
    entry points need a phone `encoder` (and take a speaker map). `vocoder`
    is a generator module (wrapped by its registered class, with `voc_hp`,
    default `hp`) or a wrapper (`vocoders/base_vocoder.py`); `self.vocoder`
    is its module, `self.voc` the wrapper."""

    def __init__(self, hp: dict, model: torch.nn.Module, pe: Optional[PitchExtractor],
                 vocoder, device=None, encoder: Optional[TokenTextEncoder] = None,
                 spk_map: Optional[Dict[str, int]] = None, voc_hp: Optional[dict] = None):
        self.device = resolve_device(device)
        self.hp = hp
        self.model = model.to(self.device).eval()
        self.pe = None if pe is None else pe.to(self.device).eval()
        self.voc = as_vocoder(vocoder, voc_hp or hp, self.device)
        self.spk_map = dict(spk_map or {})
        self.frontend = None if encoder is None else BilingualFrontend(
            encoder, phone_subst=hp.get("en_phone_subst"))
        self._tp_views = {}  # id(mesh) -> (mesh, (model, pe, vocoder wrapper))

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str = FLAGSHIP_DIR, device=None,
                        hp_overrides=None) -> "SVSInferTorch":
        """hparams_diff.json, phone_set.json and spk_map.json (the
        binarizer's vocabulary and speakers), diff_params.npz (fs2 +
        DiffNet), pe_params.npz + pe_batch_stats.npz, and the highest
        step's vocoder/**/generator_*.npz of a trained run. `hp_overrides` is a
        dict or a "k=v,..." string, as the CLI's --hparams."""
        device = resolve_device(device)
        hp = load_hparams_json(os.path.join(ckpt_dir, "hparams_diff.json"), hp_overrides)
        for fn in ("phone_set.json", "spk_map.json"):
            if not os.path.exists(os.path.join(ckpt_dir, fn)):
                raise FileNotFoundError(f"{os.path.join(ckpt_dir, fn)} is missing: the score "
                                        "front end needs the binarizer's phone set and speakers")
        encoder = build_phone_encoder(ckpt_dir)
        with open(os.path.join(ckpt_dir, "spk_map.json")) as f:
            spk_map = json.load(f)
        flat = load_npz(os.path.join(ckpt_dir, "diff_params.npz"))
        vocab = int(flat["fs2/token_embed/embed/embedding"].shape[0])
        if vocab != encoder.vocab_size:
            raise ValueError(f"phone_set.json gives {encoder.vocab_size} tokens, the token "
                             f"embedding of diff_params.npz has {vocab} rows")
        model = GaussianDiffusion(hp, vocab, hp["audio_num_mel_bins"])
        load_flax_params(model, flat)
        return cls(hp, model, *_pe_and_vocoder(ckpt_dir, hp), device, encoder=encoder,
                   spk_map=spk_map)

    @classmethod
    def from_work_dir(cls, work_dir: str, assets_dir: str = FLAGSHIP_DIR, device=None,
                      hp_overrides=None, hp: Optional[Dict[str, Any]] = None
                      ) -> "SVSInferTorch":
        """The model of a port training run, as JAX's `SVSInfer.from_work_dir`
        builds the task `task_cls` names: the diffusion stage's
        `GaussianDiffusion`, or the FFT-Singer stage's conditioner alone
        (`AuxDecoderMIDITask`, alias `FastSpeech2Task`: FastSpeech2MIDI with
        `use_midi`, else the plain FastSpeech2), served through its decoder's
        mel. The offline diffusion starts from recorded fs2 mels, which a score
        lacks, and is refused, as JAX's fails. The run's hparams: `hp` as
        given (`run.load_config` builds them for the CLI and the server:
        defaults < --config < the saved config.json < --hparams), else
        `work_dir/config.json`, with `hp_overrides` on either; the latest
        `ckpt/<step>/params.npz` of `work_dir`; the phone set and speakers its
        binarizer wrote (`binary_data_dir`); the PE of `pe_from_run` (the run
        `pe_ckpt` names); the vocoder from `assets_dir`, built from the keys of
        `assets_dir/hparams_diff.json`, its own config's, not from the acoustic
        run's."""
        from bisinger_tpu_torch.models.fs2 import FastSpeech2, FastSpeech2MIDI
        from bisinger_tpu_torch.training.checkpoints import CheckpointManager
        from bisinger_tpu_torch.training.tasks import (
            DiffSingerMIDITask,
            DiffSingerOfflineTask,
            PitchExtractionTask,
            task_class,
        )

        device = resolve_device(device)
        hp = (load_hparams_json(os.path.join(work_dir, "config.json"), hp_overrides)
              if hp is None else apply_overrides(hp, hp_overrides))
        if not hp.get("binary_data_dir"):
            raise ValueError(f"{work_dir!r}: no binary_data_dir in the run's hparams (is its "
                             "config.json missing? name the run's config with --config)")
        task = task_class(hp.get("task_cls", ""))
        if issubclass(task, DiffSingerOfflineTask):
            # JAX's SVSInfer.from_work_dir raises KeyError 'fs2_mels' here (ROADMAP Queue 3)
            raise NotImplementedError(
                f"a {task.__name__} work dir cannot serve a score: its sampler starts from the "
                "recorded fs2 mels (fs2_mels, from fs2_mel_dir), which a score does not have")
        if issubclass(task, PitchExtractionTask):
            raise ValueError(f"{work_dir!r} is a PitchExtractor run: name it as another "
                             "run's pe_ckpt")
        restored = CheckpointManager(os.path.join(work_dir, "ckpt")).restore()
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {work_dir!r}/ckpt")
        encoder = build_phone_encoder(hp["binary_data_dir"])
        with open(os.path.join(hp["binary_data_dir"], "spk_map.json")) as f:
            spk_map = json.load(f)
        if issubclass(task, DiffSingerMIDITask):
            model = GaussianDiffusion(hp, encoder.vocab_size, hp["audio_num_mel_bins"])
        else:
            model = (FastSpeech2MIDI if hp.get("use_midi") else FastSpeech2)(
                hp, encoder.vocab_size)
        load_flax_params(model, restored["params"])
        assets_hp = load_hparams_json(os.path.join(assets_dir, "hparams_diff.json"))
        _, vocoder = _pe_and_vocoder(assets_dir, assets_hp, with_pe=False)
        return cls(hp, model, pe_from_run(hp), vocoder, device, encoder=encoder,
                   spk_map=spk_map, voc_hp=assets_hp)

    @property
    def vocoder(self):
        return self.voc.model

    @vocoder.setter
    def vocoder(self, module):
        self.voc = self.voc.with_model(module)

    @property
    def vocab_size(self) -> int:
        fs2 = getattr(self.model, "fs2", self.model)  # an FFT-Singer run's model is its fs2
        return fs2.token_embed.embed.num_embeddings

    def items_to_batch(self, items: List[Dict[str, Any]], t_txt: Optional[int] = None,
                       t_mel: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Pad items to one batch, as `SVSInfer.items_to_batch`
        (`bisinger_tpu/inference/pipeline.py:157-230`) pads them: tokens to
        the token bucket, frames to the frame bucket of the score's length
        (`total_sec`, each note counted once, else the `midi_dur` sum), the
        batch axis to `bucket_batch_sizes` (padding rows: no tokens,
        speaker 0, singing). `t_txt` and `t_mel` override the buckets. A
        batch either gives every item's `mel2ph` (then `t_mel` defaults to
        the longest) or none (then durations are predicted within `n_frames`
        frames). With `use_spk_embed`, `spk_embed` [B, 256] holds each item's
        speaker vector, else zeros (and zeros on the padding rows), as
        `pipeline.py:219-229`. Training targets are not made."""
        hp = self.hp
        max_tok = max(len(it["ph_token"]) for it in items)
        t_txt = t_txt or pick_bucket(max_tok, hp["bucket_tokens"])
        given = [it.get("mel2ph") is not None for it in items]
        if any(given) and not all(given):
            raise ValueError("give mel2ph for every request of a batch or for none")
        if all(given):
            frames = [len(it["mel2ph"]) for it in items]
        else:
            frames = [int(float(it.get("total_sec") or np.sum(it["midi_dur"]))
                          * hp["audio_sample_rate"] / hp["hop_size"]) + 8 for it in items]
        t_mel = t_mel or pick_bucket(max(frames), hp["bucket_frames"])
        if max_tok > t_txt or max(frames) > t_mel:
            print(f"| WARNING: score exceeds the largest static bucket (tokens {max_tok}>"
                  f"{t_txt} or frames {max(frames)}>{t_mel}) and will be TRUNCATED — split "
                  "the score (the HTTP server's chunked synthesis does this) or raise "
                  "bucket_tokens/bucket_frames", flush=True)
        b = len(items)
        b_buckets = hp.get("bucket_batch_sizes") or []
        if b_buckets and b <= max(b_buckets):
            b = pick_bucket(b, b_buckets)
        n_pad = b - len(items)

        def pad(key, dtype, width):
            out = np.zeros((b, width), dtype)
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
            "spk_ids": np.asarray([it["spk_id"] for it in items] + [0] * n_pad, np.int64),
            "speechsing": np.asarray([it.get("speechsing", 1) for it in items] + [1] * n_pad,
                                     np.int64),
            "n_frames": t_mel,
        }
        if all(given):
            batch["mel2ph"] = pad("mel2ph", np.int64, t_mel)
        if hp.get("use_spk_embed"):
            batch["spk_embed"] = np.stack(
                [np.asarray(it.get("spk_embed", np.zeros(256)), np.float32) for it in items]
                + [np.zeros(256, np.float32)] * n_pad)
        return batch

    def tp_views(self, m):
        """The model, the PE and the vocoder as model rank `m.index`'s views
        (`tensor.shard_for_tp`), built at the first call under `m`."""
        got = self._tp_views.get(id(m))
        if got is None or got[0] is not m:
            pe = None if self.pe is None else tensor.shard_for_tp(self.pe, m)
            got = (m, (tensor.shard_for_tp(self.model, m), pe,
                       self.voc.with_model(tensor.shard_for_tp(self.voc.model, m))))
            self._tp_views[id(m)] = got
        return got[1]

    @torch.no_grad()
    def synthesize(self, batch: Dict[str, Any], start_noise=None, nsf_phase=None,
                   nsf_noise=None, generator: Optional[torch.Generator] = None,
                   step_noise=None, pwg_z=None) -> Dict[str, torch.Tensor]:
        """One batch -> {"wav" [B, T*hop], "mel" [B, T, 80], "f0" [B, T],
        "mel2ph" [B, T]}, the vocoder's output before any post-denoising.
        Random draws (diffusion start, DDPM's steps, NSF phase and noise, a
        PWG's z) come from `generator` unless given. Under `seq` (the mesh
        `sequence.context` finds, passed to the model, the PE and the
        vocoder) this rank's rows and core frames; under a ('data', 'model')
        mesh (`tensor.context`) the whole batch through the model rank's
        views (module docstring)."""
        m = sequence.context(self.hp)
        tp = tensor.context()
        if tp is not None:
            if m is not None:
                raise NotImplementedError("synthesize under both a seq and a model mesh")
            # every rank holds the whole batch: the batch's collectives (the
            # ESM's keys) over the mesh's data group, this rank's alone at (1, n)
            with dp.using_data_group(tp.data_group):
                return self._synthesize(batch, start_noise, nsf_phase, nsf_noise, generator,
                                        step_noise, pwg_z, self.tp_views(tp), None)
        return self._synthesize(batch, start_noise, nsf_phase, nsf_noise, generator,
                                step_noise, pwg_z, (self.model, self.pe, self.voc), m)

    def _synthesize(self, batch, start_noise, nsf_phase, nsf_noise, generator, step_noise,
                    pwg_z, parts, m):
        """`synthesize` through `parts` (model, PE, vocoder wrapper), under the
        seq mesh `m` or None."""
        dev = self.device
        model, pe, voc = parts
        if m is not None:  # this rank's rows; the conditioner takes every frame
            batch = sequence.shard_longform_batch(batch, m, halo=None)
        as_t = lambda k: torch.as_tensor(batch[k], device=dev)  # noqa: E731
        mel2ph = batch.get("mel2ph")
        cond = {k: as_t(k) for k in ("pitch_midi", "midi_dur", "is_slur", "lang", "speechsing")
                } if self.hp.get("use_midi") else {}
        if "spk_embed" in batch:
            cond["spk_embed"] = as_t("spk_embed").float()
        if isinstance(model, GaussianDiffusion):
            cond.update(start_noise=start_noise, step_noise=step_noise, generator=generator,
                        seq=m)
        ret = model(
            as_t("txt_tokens"),
            mel2ph=None if mel2ph is None else torch.as_tensor(mel2ph, device=dev),
            spk_id=as_t("spk_ids"), max_frames=batch.get("n_frames") if mel2ph is None else None,
            **cond,
        )
        mel, mel2ph = ret["mel_out"], ret["mel2ph"]
        if m is not None:  # the diffusion's mel is the core already; the conditioner's whole
            mel2ph = sequence.core_of(mel2ph, m)
            if not isinstance(model, GaussianDiffusion):
                mel = sequence.core_of(mel, m)
        if pe is not None:
            f0 = pe(mel, seq=m)["f0_denorm_pred"]
        elif "f0_denorm" in ret:
            f0 = ret["f0_denorm"] if m is None else sequence.core_of(ret["f0_denorm"], m)
        else:  # the NSF source runs unvoiced
            f0 = torch.zeros(mel.shape[:2], device=dev)
        wav = voc.generate(mel, f0, generator, phase=nsf_phase, noise=nsf_noise, z=pwg_z, seq=m)
        return {"wav": wav, "mel": mel, "f0": f0, "mel2ph": mel2ph}

    # ---- score entry points ------------------------------------------------
    def score_items(self, inputs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Scores -> items through the front end; a score's `spk_embed` (a
        speaker vector) rides along into its item."""
        if self.frontend is None:
            raise RuntimeError("no phone encoder: build with from_checkpoint or pass encoder=")
        items = []
        for inp in inputs:
            item = self.frontend(inp, self.spk_map)
            if inp.get("spk_embed") is not None:
                item["spk_embed"] = np.asarray(inp["spk_embed"], np.float32)
            items.append(item)
        return items

    @torch.no_grad()
    def infer_batch(self, inputs: List[Dict[str, Any]],
                    generator: Optional[torch.Generator] = None, **pins) -> List[np.ndarray]:
        """Several scores in one batch -> one float32 waveform each, trimmed
        to its filled frames x hop (after the vocoder's post-denoising, on
        the padded batch). Without a generator the draws come from one
        seeded with 0, so a request repeated gives the same audio; `pins`
        (start_noise, step_noise, nsf_phase, nsf_noise, pwg_z) fix them at
        the padded batch's shapes."""
        items = self.score_items(inputs)
        batch = self.items_to_batch(items)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = self.synthesize(batch, generator=generator, **pins)
        m = sequence.context(self.hp)
        if m is not None:  # every rank's rows and frames
            out = {k: sequence.gather_whole(out[k], m) for k in ("wav", "mel2ph")}
        wavs = self.voc.postprocess(out["wav"].float().cpu().numpy())  # one host fetch
        mel2ph = out["mel2ph"].cpu().numpy()
        filled = (mel2ph > 0).sum(axis=1)
        t_mel = mel2ph.shape[1]
        full = int((filled[: len(items)] >= t_mel).sum())
        if full:
            print(f"| WARNING: predicted durations fill the entire mel bucket (t_mel={t_mel}) "
                  f"for {full} item(s) — output is likely truncated; split the score or raise "
                  "bucket_frames", flush=True)
        hop = self.hp["hop_size"]
        return [wavs[i][: max(int(filled[i]), 1) * hop] for i in range(len(items))]

    @torch.no_grad()
    def infer_once(self, inp: Dict[str, Any],
                   generator: Optional[torch.Generator] = None) -> np.ndarray:
        return self.infer_batch([inp], generator)[0]

    def infer_from_json(self, json_fn: str, save_dir: str) -> List[str]:
        """Batch inference over a JSON list of scores, `JSON_GROUP` scores a
        batch; each WAV is written by a thread pool while the next batch
        runs. With `profile_infer` set, prints audio seconds made per
        second."""
        with open(json_fn) as f:
            inputs = json.load(f)
        os.makedirs(save_dir, exist_ok=True)
        sr = self.hp["audio_sample_rate"]
        paths, futures, audio_seconds = [], [], 0.0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as pool:
            for start in range(0, len(inputs), JSON_GROUP):
                group = inputs[start: start + JSON_GROUP]
                for i, (inp, wav) in enumerate(zip(group, self.infer_batch(group))):
                    name = inp.get("item_name", f"item_{start + i}")
                    path = os.path.join(save_dir, f"{name}.wav")
                    futures.append(pool.submit(save_wav, wav, path, sr))
                    audio_seconds += len(wav) / sr
                    paths.append(path)
            for f in futures:
                f.result()
        if self.hp.get("profile_infer"):
            dt = time.perf_counter() - t0
            print(f"| profile_infer: {audio_seconds:.2f} audio-s in {dt:.2f} s "
                  f"({audio_seconds / max(dt, 1e-9):.2f} audio-s/s)", flush=True)
        return paths
