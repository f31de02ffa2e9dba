"""The training tasks of the acoustic stages and the PitchExtractor
(counterpart of `bisinger_tpu/training/tasks.py:42-467`):

  - `AuxDecoderMIDITask` (alias `FastSpeech2Task`): the fs2 stage alone,
    FastSpeech2MIDI with `use_midi`, else the plain FastSpeech2; losses mel
    (l1 + SSIM), phone/word/sentence duration, and the pitch (f0, uv) and
    energy losses when their embeddings are on; rsqrt schedule.
  - `DiffSingerMIDITask` (and `DiffSingerTask`, `DiffFsTask`, which differ
    only in their configs): the diffusion stage over the fs2 conditioner
    `use_midi` picks; losses the diffusion loss (`mel`), the durations,
    pitch and energy; step decay schedule; `warm_start_fs2` loads the fs2
    stage's parameters; `step_flags` is the `switch_midi2f0_step`
    curriculum (past it the model is fed no f0/uv).
  - `DiffSpeechTask`: the same with the conditioner frozen but for its
    predictors (`optim.predictor_only_frozen`: zero updates, zero Adam
    moments, as `optax.set_to_zero` under `optax.masked`).
  - `DiffSingerOfflineTask`: `OfflineGaussianDiffusion` (no conditioner
    decoder; its inference starts from recorded fs2 mels, `fs2_mel_dir`).
  - `PitchExtractionTask`: the PitchExtractor, mel -> f0 and uv; losses
    the f0 loss and the uv BCE; rsqrt schedule; its Prenet's BatchNorm
    statistics are part of its state, and `export` writes them beside the
    parameters (pe_params.npz, pe_batch_stats.npz); it takes no
    vocabulary.

A task owns the model (on its device, initialised as flax initialises it),
the optimizer (`training/optim.AdamW`) and the losses. `train_step` runs
the model in train mode under autograd: dropout from the generator it is
handed, the diffusion stage's t and noise from it too, or pinned by the
caller. No step reaches K1 or K2, as no step in the JAX package reaches a
Pallas kernel. The GAN vocoder task is `training/vocoder_task.py`.

Under data parallelism (`parallel/mesh.py`) each rank's step is its share
of JAX's SPMD step on the global batch: its losses are partial sums of the
global ones, so after the backward pass the gradients are summed over the
ranks (`GradientReducer`), and the clip, Adam and the accumulation then run
on the same gradients on every rank; the returned losses are summed over
the ranks, so every rank reads the global values.
"""

from __future__ import annotations

import math
import os
from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from bisinger_tpu_torch import resolve_device
from bisinger_tpu_torch.models.common import Embedding, set_dropout_generator
from bisinger_tpu_torch.models.diffnet import DiffNet, FFTDenoiser
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion, OfflineGaussianDiffusion
from bisinger_tpu_torch.models.fs2 import FastSpeech2, FastSpeech2MIDI
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.parallel import sequence
from bisinger_tpu_torch.parallel.mesh import GradientReducer, reduce_values
from bisinger_tpu_torch.training import losses as L
from bisinger_tpu_torch.training.checkpoints import load_params_into
from bisinger_tpu_torch.training.optim import AdamW, predictor_only_frozen
from bisinger_tpu_torch.utils.cwt import cwt2f0_norm
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params


def model_kwargs(batch: Dict[str, torch.Tensor], hp, drop_f0: bool = False
                 ) -> Dict[str, Any]:
    """A batch as the model's keywords (`tasks.py:42-72`): the speaker (its
    id, or with `use_spk_embed` the batch's speaker vectors), f0, uv and
    energy (f0 and uv left out with `drop_f0`), and the MIDI inputs with
    `use_midi`. With `pitch_type: cwt` the f0 is the inverse of the
    batch's recorded CWT spectrogram (`cwt2f0_norm`)."""
    f0 = None if drop_f0 else batch.get("f0")
    if f0 is not None and hp["pitch_type"] == "cwt" and "cwt_spec" in batch:
        f0 = cwt2f0_norm(batch["cwt_spec"], batch["f0_mean"], batch["f0_std"], batch["mel2ph"],
                         hp["pitch_norm"], hp["use_uv"])
    kw = dict(txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"],
              spk_id=batch["spk_ids"], f0=f0, uv=None if drop_f0 else batch.get("uv"),
              energy=batch.get("energy"))
    if not hp["use_spk_id"]:
        kw["spk_embed"] = batch.get("spk_embed")
    if hp.get("use_midi"):
        kw.update(pitch_midi=batch.get("pitch_midi"), midi_dur=batch.get("midi_dur"),
                  is_slur=batch.get("is_slur"), lang=batch.get("lang"),
                  speechsing=batch.get("speechsing"))
    return kw


_CDF_2 = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))  # the standard normal's CDF at 2


def lecun_normal_(w, gen):
    """flax's default kernel init: a normal truncated at 2 std, scaled to
    variance 1/fan_in; drawn by the inverse CDF (one uniform draw a value)."""
    std = math.sqrt(1.0 / (w[0].numel())) / 0.87962566103423978
    u = torch.rand(w.shape, generator=gen) * (2 * _CDF_2 - 1) + (1 - _CDF_2)
    with torch.no_grad():
        w.copy_(torch.erfinv(2 * u - 1) * (math.sqrt(2.0) * std))


XAVIER = ("q_proj", "k_proj", "v_proj", "out_proj", "Dense_0", "ffn1", "ffn2")


def flax_init_(model: nn.Module, seed: int, xavier=XAVIER) -> nn.Module:
    """Initialise `model` as its flax counterpart initialises its
    parameters: Dense and Conv kernels lecun-normal; the projections
    named in `xavier` (a module's name or its path; by default the
    attention and FFN projections) xavier-uniform; the DiffNet's convs and
    the FFT denoiser's input projection He-normal, the DiffNet's output
    projection zero; embeddings normal(dim^-0.5); biases zero, norms one."""
    gen = torch.Generator().manual_seed(int(seed))
    he = ("input_projection", "skip_projection", "dilated_conv", "conditioner_projection",
          "output_projection")
    diffnets = [m for m in model.modules() if isinstance(m, DiffNet)]
    in_diffnets = {id(sub) for d in diffnets for sub in d.modules()}
    zero = {id(d.output_projection) for d in diffnets}
    he_ids = {id(m.input_projection) for m in model.modules() if isinstance(m, FFTDenoiser)}
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        in_diffnet = id(m) in in_diffnets
        if isinstance(m, Embedding):
            with torch.no_grad():
                m.embed.weight.copy_(torch.randn(m.embed.weight.shape, generator=gen)
                                     * m.embed.weight.shape[1] ** -0.5)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            w = m.weight
            if id(m) in zero:
                nn.init.zeros_(w)
            elif (in_diffnet and leaf in he) or id(m) in he_ids:
                with torch.no_grad():
                    w.copy_(torch.randn(w.shape, generator=gen)
                            * math.sqrt(2.0 / w[0].numel()))
            elif (leaf in xavier or name in xavier) and not in_diffnet:
                fan_in, fan_out = w[0].numel(), w.shape[0] * (w[0].numel() // w.shape[1])
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                with torch.no_grad():
                    w.copy_(torch.rand(w.shape, generator=gen) * 2 * bound - bound)
            else:
                lecun_normal_(w, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return model


class AuxDecoderMIDITask:
    """The fs2 stage: FastSpeech2MIDI (`use_midi`) or FastSpeech2 alone."""

    schedule = "rsqrt"
    freeze_fs2 = False

    def __init__(self, hp, vocab_size: int, device=None):
        if hp.get("dur_loss") == "crf" and hp.get("use_midi", True):
            # JAX's refusal (`tasks.py:78-88`)
            raise ValueError(
                "dur_loss: crf caps durations at 31 frames (torchcrf "
                "parity) and is speech-only; singing/MIDI configs must "
                "use dur_loss: mse or mog")
        self.hp = hp
        self.vocab_size = vocab_size
        self.device = resolve_device(device)
        self.model = flax_init_(self.build_model(), hp.get("seed", 1234)).to(self.device)
        self.opt = self.build_optimizer()
        self.reduce_gradients = GradientReducer(dict(self.model.named_parameters()))

    def build_model(self) -> nn.Module:
        return (FastSpeech2MIDI if self.hp.get("use_midi") else FastSpeech2)(self.hp,
                                                                              self.vocab_size)

    def to(self, device) -> "AuxDecoderMIDITask":
        """The model moved to `device` (as `__init__` moves it), the
        optimizer afresh (for a task not yet stepped); returns the task."""
        self.device = resolve_device(device)
        self.model.to(self.device)
        self.opt = self.build_optimizer()
        self.reduce_gradients = GradientReducer(dict(self.model.named_parameters()))
        return self

    def build_optimizer(self, steps_per_epoch: Optional[int] = None) -> AdamW:
        params = dict(self.model.named_parameters())
        return AdamW(params, self.hp, self.schedule, steps_per_epoch,
                     frozen=predictor_only_frozen(params) if self.freeze_fs2 else ())

    def configure_accumulation(self, steps_per_epoch: int):
        """The per-epoch (dict) accumulation needs batches per epoch: rebuild
        the optimizer once the trainer knows them."""
        if isinstance(self.hp.get("accumulate_grad_batches", 1), Mapping):
            self.opt = self.build_optimizer(steps_per_epoch)

    # ---- state -----------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        return {"params": export_flax_params(self.model), "opt_state": self.opt.state_dict()}

    def load_state(self, params: Dict[str, np.ndarray], opt_state: Optional[Dict] = None):
        load_flax_params(self.model, params)
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)

    # ---- forward and losses ----------------------------------------------
    def forward(self, batch, generator=None, drop_f0: bool = False, t=None, noise=None):
        return self.model(**model_kwargs(batch, self.hp, drop_f0), ref_mels=batch["mels"])

    def _dur_losses(self, ret, batch, losses):
        wdb = batch.get("word_boundary")
        if wdb is None and "ph_is_sil" in batch and ret["dur"].ndim == 2:
            L.add_dur_loss_sil(ret["dur"], batch["mel2ph"], batch["txt_tokens"],
                               batch["ph_is_sil"].float(), losses, self.hp)
        else:  # the MIDI tasks' losses, and any head but log durations (`tasks.py:155-165`)
            L.add_dur_loss_midi(ret["dur"], batch["mel2ph"], batch["txt_tokens"], wdb, losses,
                                self.hp, ret.get("crf_transitions"))

    def _variance_losses(self, ret, batch, losses):
        if self.hp.get("use_pitch_embed"):
            L.add_pitch_loss(ret, batch, losses, self.hp)
        if self.hp.get("use_energy_embed"):
            L.add_energy_loss(ret["energy_pred"], batch["energy"], losses, self.hp)

    def compute_losses(self, ret, batch) -> Dict[str, torch.Tensor]:
        losses: Dict[str, torch.Tensor] = {}
        L.add_mel_loss(ret["mel_out"], batch["mels"], losses, self.hp)
        self._dur_losses(ret, batch, losses)
        self._variance_losses(ret, batch, losses)
        return losses

    # ---- steps -----------------------------------------------------------
    def train_step(self, batch, generator=None, drop_f0: bool = False, t=None, noise=None
                   ) -> Dict[str, torch.Tensor]:
        """One update (or accumulation mini-step) on `batch`; returns the
        detached losses, their total and the gradients' global norm."""
        self.model.train()
        set_dropout_generator(self.model, generator)
        ret = self.forward(batch, generator, drop_f0, t, noise)
        losses = self.compute_losses(ret, batch)
        total = sum(losses.values())
        self.opt.zero_grad()
        total.backward()
        self.reduce_gradients()
        grad_norm = AdamW.global_norm(self.opt.grads())
        self.opt.step()
        out = reduce_values({k: v.detach() for k, v in {**losses, "total_loss": total}.items()})
        out["grad_norm"] = grad_norm
        return out

    @torch.no_grad()
    def val_step(self, batch, generator=None, drop_f0: bool = False, t=None, noise=None
                 ) -> Dict[str, torch.Tensor]:
        self.model.eval()
        losses = self.compute_losses(self.forward(batch, generator, drop_f0, t, noise), batch)
        losses["total_loss"] = sum(losses.values())
        return reduce_values(losses)


class DiffSingerMIDITask(AuxDecoderMIDITask):
    """The shallow-diffusion stage over the fs2 conditioner."""

    schedule = "step"

    def build_model(self) -> nn.Module:
        return GaussianDiffusion(self.hp, self.vocab_size, self.hp["audio_num_mel_bins"])

    def step_flags(self, step: Optional[int]) -> Dict[str, Any]:
        """switch_midi2f0_step: past N updates the model is fed no
        ground-truth f0/uv (`usr/diffsinger_task.py:391-399`)."""
        sw = self.hp.get("switch_midi2f0_step")
        return {"drop_f0": bool(sw is not None and step is not None and step > sw)}

    def forward(self, batch, generator=None, drop_f0: bool = False, t=None, noise=None):
        return self.model.train_forward(**model_kwargs(batch, self.hp, drop_f0),
                                        ref_mels=batch["mels"], t=t, noise=noise,
                                        generator=generator)

    def compute_losses(self, ret, batch) -> Dict[str, torch.Tensor]:
        losses = {"mel": ret["diff_loss"]}
        self._dur_losses(ret, batch, losses)
        self._variance_losses(ret, batch, losses)
        return losses

    @torch.no_grad()
    def infer_step(self, batch, start_noise=None, step_noise=None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Inference as JAX's `DiffSingerMIDITask.infer_step`
        (`bisinger_tpu/training/tasks.py:297-306`): durations from the
        predictor (the batch's mel2ph, f0 and uv unused) within the batch's
        frames (`n_frames`, else its mels' length), then the sampler -> the
        model's dict (`mel_out`, ...). The draws come from `generator` or
        the pins. Under `sequence_parallel_axis` (an entered seq mesh) the
        batch is this rank's rows with every frame
        (`sequence.shard_longform_batch(batch, mesh, halo=None)`), the pins
        are at the global shape, and `mel_out` is the rank's core frames."""
        self.model.eval()
        kw = model_kwargs(batch, self.hp)
        kw.update(mel2ph=None, f0=None, uv=None)
        n_frames = batch.get("n_frames") or batch["mels"].shape[1]
        return self.model(**kw, max_frames=int(n_frames), start_noise=start_noise,
                          step_noise=step_noise, generator=generator,
                          seq=sequence.context(self.hp))

    def warm_start_fs2(self, fs2_params: Dict[str, np.ndarray], subtree: str = ""):
        """Load the FFT-Singer stage's parameters (flat flax keys; under
        `subtree` of `fs2_params` if given) into the conditioner, where the
        names and shapes agree (reference `usr/diffsinger_task.py:64-65`);
        raises when none does."""
        own = export_flax_params(self.model.fs2)
        merged = load_params_into(own, fs2_params, subtree)
        if all(merged[k] is own[k] for k in own):
            raise ValueError("warm start: no parameter of the source matches the conditioner's "
                             "names and shapes")
        load_flax_params(self.model.fs2, merged)


# the reference's names for the same loop (`tasks.py:429-437`): DiffSinger
# without MIDI (its configs unset use_midi), and plain diffusion (run with
# gaussian_start and K_step = timesteps)
DiffSingerTask = DiffFsTask = DiffSingerMIDITask


class DiffSpeechTask(DiffSingerMIDITask):
    """Shallow-diffusion TTS (`tasks.py:420-426`): the conditioner frozen
    but for its predictors."""

    freeze_fs2 = True


class DiffSingerOfflineTask(DiffSingerMIDITask):
    """The offline variant (`tasks.py:440-490`): `OfflineGaussianDiffusion`,
    whose inference starts from a batch's recorded fs2 mels (`fs2_mels`,
    from `fs2_mel_dir`); its training step is the diffusion stage's, which
    reads no fs2 mel, as JAX's does not."""

    def build_model(self) -> nn.Module:
        return OfflineGaussianDiffusion(self.hp, self.vocab_size, self.hp["audio_num_mel_bins"])


# the reference's name: the fs2 stage's task covers the plain FastSpeech2
FastSpeech2Task = AuxDecoderMIDITask


class PitchExtractionTask(AuxDecoderMIDITask):
    """PitchExtractor training: mel -> (f0, uv) (`tasks.py:309-387`). A
    train step runs the predictor's dropout and the Prenet's batch
    statistics, which update the running ones (saved with the parameters
    under their flax names, `mel_prenet/norm_i/{mean,var}`)."""

    schedule = "rsqrt"

    def __init__(self, hp, device=None):
        self.hp = hp
        self.device = resolve_device(device)
        # flax's initialisers: ConvStacks' projections xavier, the rest lecun
        self.model = flax_init_(PitchExtractor(hp), hp.get("seed", 1234),
                                xavier=("mel_encoder.in_proj", "mel_encoder.out_proj")
                                ).to(self.device)
        self.opt = self.build_optimizer()
        self.reduce_gradients = GradientReducer(dict(self.model.named_parameters()))

    def forward(self, batch, generator=None, drop_f0: bool = False, t=None, noise=None):
        return self.model(batch["mels"], deterministic=not self.model.training)

    def compute_losses(self, ret, batch) -> Dict[str, torch.Tensor]:
        losses: Dict[str, torch.Tensor] = {}
        nonpadding = (batch["mel2ph"] != 0).float()
        L.add_f0_loss(ret["pitch_pred"], batch["f0"], batch["uv"], nonpadding, losses, self.hp)
        return losses

    @torch.no_grad()
    def infer_step(self, mels) -> Dict[str, torch.Tensor]:
        """Eval mode, the running statistics: {"pitch_pred", "f0_denorm_pred"}."""
        self.model.eval()
        return self.model(mels)

    def export(self, out_dir: str) -> None:
        """pe_params.npz (parameters) and pe_batch_stats.npz (the BatchNorm
        running statistics) into `out_dir`, as the inference path reads them."""
        flat = export_flax_params(self.model)
        stats = {k: v for k, v in flat.items() if k.rsplit("/", 1)[-1] in ("mean", "var")}
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, "pe_params.npz"),
                 **{k: v for k, v in flat.items() if k not in stats})
        np.savez(os.path.join(out_dir, "pe_batch_stats.npz"), **stats)


# the classes `task_cls` names, by the last part of a dotted name (the
# reference's, the JAX package's or the port's; `bisinger_tpu/run.py:41-51`)
TASKS = {c.__name__: c for c in (AuxDecoderMIDITask, DiffSingerMIDITask, DiffSpeechTask,
                                 DiffSingerOfflineTask, PitchExtractionTask)}
TASKS.update(FastSpeech2Task=FastSpeech2Task, DiffSingerTask=DiffSingerTask,
             DiffFsTask=DiffFsTask)


def task_class(name: str):
    """`task_cls` (empty for the diffusion stage) -> the port's task class."""
    short = (name or "DiffSingerMIDITask").rsplit(".", 1)[-1]
    if short not in TASKS:
        raise NotImplementedError(f"task_cls={name!r} is not ported (the port has "
                                  f"{', '.join(sorted(TASKS))})")
    return TASKS[short]
