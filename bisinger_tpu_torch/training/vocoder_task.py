"""The HiFi-GAN vocoder's GAN training task (counterpart of
`bisinger_tpu/training/vocoder_task.py:1-203`), NSF or plain.

One step updates the discriminators (MPD + MSD, LSGAN) on a generated
waveform cut from the graph, then the generator against the updated
discriminators: adversarial loss, feature matching, 45 x the log-mel L1
(`lambda_mel`) and, under `use_mrstft_loss`, the multi-resolution STFT
loss. Both passes of the generator share one NSF draw (harmonic phase and
noise), as `vocoder_task.py:153` draws `rng_g` once. With `use_nsf` off
the generator is handed no f0, and has no harmonic source to train: a
departure from JAX's task, which hands it the batch's f0 whatever
`use_nsf` says (`vocoder_task.py:106-108, 152-157`), so trains a source
that its wrapper then never runs (`vocoders/hifigan.py:90, 108`); given
f0=None, JAX's task computes the port's step. Every kernel trains
as a weight-norm pair (`training/weight_norm.py`; the JAX package's
default, `vocoder_weight_norm: true`, which nothing turns off); each side
has its own `AdamW` in the "vocoder" mode
(optax.adamw). A multiband generator's subbands go through PQMF synthesis
before the discriminators and the losses. The generator runs its train-mode
layer path: no step launches K2. A step's forward and optimizer parts
run under `torch.profiler.record_function` ranges ("D forward", "D
optimizer", "G forward" with "G forward: generator" and "G forward:
discriminators" inside it, "G optimizer"), which `tools/profile_train.py`
reads (the backward runs on autograd's thread, outside any range).

Data: {"mels" [B, T, 80], "f0" [B, T] (read with `use_nsf`), "wav" [B, T * hop]}.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from bisinger_tpu_torch import resolve_device
from bisinger_tpu_torch.models.hifigan import (
    HifiGanGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from bisinger_tpu_torch.models.pqmf import pqmf_from_hparams
from bisinger_tpu_torch.ops.stft import log_mel_spectrogram, stft_magnitude
from bisinger_tpu_torch.training import weight_norm as wn
from bisinger_tpu_torch.training.optim import AdamW
from bisinger_tpu_torch.training.tasks import lecun_normal_

HARMONICS = 9  # the NSF source's fundamental and 8 overtones


def multi_resolution_stft_loss(wav_pred, wav_gt,
                               resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))):
    """(spectral convergence, log-magnitude L1), each averaged over the
    resolutions (fft, hop, win), as the PWG auxiliary loss."""
    sc_total, mag_total = 0.0, 0.0
    for fft, hop, win in resolutions:
        s_pred = stft_magnitude(wav_pred, fft, hop, win)
        s_gt = stft_magnitude(wav_gt, fft, hop, win)
        sc = torch.linalg.vector_norm(s_gt - s_pred) / torch.clamp_min(
            torch.linalg.vector_norm(s_gt), 1e-6)
        mag = torch.abs(torch.log(torch.clamp_min(s_gt, 1e-6))
                        - torch.log(torch.clamp_min(s_pred, 1e-6))).mean()
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n


def mel_l1(wav_pred, wav_gt, hp):
    """Mean |log-mel(pred) - log-mel(gt)| with the hparams' audio settings."""
    kw = dict(sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
              hop_size=hp["hop_size"], win_size=hp["win_size"],
              num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"], fmax=hp["fmax"])
    return torch.abs(log_mel_spectrogram(wav_pred, **kw)
                     - log_mel_spectrogram(wav_gt, **kw)).mean()


class Discriminators(nn.Module):
    """MPD and MSD under one tree, as the JAX task's {"mpd", "msd"}."""

    def __init__(self):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator()
        self.msd = MultiScaleDiscriminator()

    def forward(self, y, y_hat):
        return self.mpd(y, y_hat), self.msd(y, y_hat)


def flax_init_(module: nn.Module, seed: int, small=()) -> nn.Module:
    """flax's initialisers: normal(0.01) for the kernels under a top-level
    module whose name starts with one in `small` (the reference's
    init_weights), lecun normal for every other kernel, zero biases,
    LayerNorm scales one."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)):
            if name.split(".")[0].startswith(small):
                with torch.no_grad():
                    m.weight.copy_(0.01 * torch.randn(m.weight.shape, generator=gen))
            else:
                lecun_normal_(m.weight, gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module


class HifiGanTask:
    def __init__(self, hp, device=None, seed: int = 0):
        self.hp = hp
        self.device = resolve_device(device)
        self.generator = HifiGanGenerator(hp).to(self.device)
        self.disc = Discriminators().to(self.device)
        self.lambda_mel = float(hp.get("lambda_mel", 45.0))
        self.use_mrstft = bool(hp.get("use_mrstft_loss", False))
        self.pqmf = pqmf_from_hparams(hp)
        self.hop = int(np.prod(hp["upsample_rates"])) * (self.pqmf.subbands if self.pqmf else 1)
        self.init_states(seed)

    # ---- state -----------------------------------------------------------
    def init_states(self, seed: int):
        """flax's initialisation of all three networks (the generator's MRF
        convs, upsamplers and conv_post at normal(0.01)), then (g, v) for
        every normed kernel and a fresh optimizer for each side."""
        flax_init_(self.generator, seed, small=("res_", "up_", "conv_post"))
        flax_init_(self.disc, seed + 1)
        self.gen_params = wn.decompose(self.generator)
        self.disc_params = wn.decompose(self.disc)
        self._new_optimizers()

    def _new_optimizers(self):
        self.gen_opt = AdamW(self.gen_params, self.hp, "vocoder")
        self.disc_opt = AdamW(self.disc_params, self.hp, "vocoder")

    def load_flax_trees(self, gen_flat: Dict[str, np.ndarray], disc_flat: Dict[str, np.ndarray]):
        """Set both sides' trainable leaves from the JAX task's flat
        (decomposed) trees; the optimizers start afresh."""
        wn.load_flax_tree(self.generator, self.gen_params, gen_flat)
        wn.load_flax_tree(self.disc, self.disc_params, disc_flat)
        self._new_optimizers()

    def export_gen_params(self) -> Dict[str, np.ndarray]:
        """The generator's plain kernels under flax's names (generator_*.npz)."""
        return wn.export(self.generator, self.gen_params)

    # ---- forward and losses ----------------------------------------------
    def nsf_draws(self, mel, generator: Optional[torch.Generator] = None):
        """One step's NSF phase [B, 9] ~ U[0, 1) and noise [B, T * hop, 9] ~ N(0, 1)."""
        b, t = mel.shape[:2]
        return (torch.rand((b, HARMONICS), generator=generator, device=mel.device),
                torch.randn((b, t * self.hop, HARMONICS), generator=generator,
                            device=mel.device))

    def generate(self, gen_params, mel, f0, phase, noise):
        """The generator's train-mode pass on `gen_params`, PQMF-synthesised
        when multiband: wav [B, T * hop]."""
        self.generator.train()
        out = wn.apply(self.generator, gen_params, mel, f0, phase=phase, noise=noise)
        return self.pqmf.synthesis(out) if self.pqmf is not None else out

    def disc_losses(self, disc_params, wav, fake):
        (mpd_r, mpd_g, _, _), (msd_r, msd_g, _, _) = wn.apply(self.disc, disc_params, wav, fake)
        r1, g1 = discriminator_loss(mpd_r, mpd_g)
        r2, g2 = discriminator_loss(msd_r, msd_g)
        return r1 + g1 + r2 + g2, {"disc_real": r1 + r2, "disc_fake": g1 + g2}

    def gen_losses(self, gen_params, disc_weights, mel, f0, wav, phase, noise):
        with record_function("G forward: generator"):
            fake = self.generate(gen_params, mel, f0, phase, noise)
        with record_function("G forward: discriminators"):
            (_, mpd_g, fmap_mr, fmap_mg), (_, msd_g, fmap_sr, fmap_sg) = functional_call(
                self.disc, disc_weights, (wav, fake))
        adv = generator_loss(mpd_g) + generator_loss(msd_g)
        fm = feature_loss(fmap_mr, fmap_mg) + feature_loss(fmap_sr, fmap_sg)
        mel_loss = mel_l1(fake, wav, self.hp) * self.lambda_mel
        total = adv + fm + mel_loss
        aux = {"gen_adv": adv, "gen_fm": fm, "gen_mel": mel_loss}
        if self.use_mrstft:
            sc, mag = multi_resolution_stft_loss(fake, wav)
            total = total + sc + mag
            aux.update(gen_sc=sc, gen_mag=mag)
        return total, aux

    # ---- step ------------------------------------------------------------
    def train_step(self, batch, generator: Optional[torch.Generator] = None, phase=None,
                   noise=None) -> Dict[str, torch.Tensor]:
        """The discriminators' update, then the generator's; returns the
        detached losses. `phase` and `noise` pin the step's NSF draw, else
        it comes from `generator`."""
        mel, wav = batch["mels"], batch["wav"]
        f0 = batch["f0"] if self.generator.use_nsf else None
        if self.generator.use_nsf and (phase is None or noise is None):
            phase, noise = self.nsf_draws(mel, generator)
        with record_function("D forward"):
            with torch.no_grad():
                fake = self.generate(self.gen_params, mel, f0, phase, noise)
            d_loss, d_aux = self.disc_losses(self.disc_params, wav, fake)
        self.disc_opt.zero_grad()
        d_loss.backward()
        with record_function("D optimizer"):
            self.disc_opt.step()

        with record_function("G forward"):
            with torch.no_grad():  # the updated discriminators, as constants
                disc_weights = {k: v.detach() for k, v in wn.compose(self.disc_params).items()}
            g_loss, g_aux = self.gen_losses(self.gen_params, disc_weights, mel, f0, wav, phase,
                                            noise)
        self.gen_opt.zero_grad()
        g_loss.backward()
        with record_function("G optimizer"):
            self.gen_opt.step()
        out = {"disc_loss": d_loss, "gen_loss": g_loss, **d_aux, **g_aux}
        return {k: v.detach() for k, v in out.items()}
