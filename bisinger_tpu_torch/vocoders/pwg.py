"""The Parallel WaveGAN inference wrapper (counterpart of
`bisinger_tpu/vocoders/pwg.py:19-51`).

`PWG(hp)` loads the newest `<vocoder_ckpt>/generator_*.npz` (or takes
`params`, or a `model`) into `models/pwg.ParallelWaveGANGenerator`, which
reads the `pwg_*` keys and refuses upsample scales whose product is not
`hop_size`. `generate` draws z ~ N(0, 1) of length T * hop from the
caller's generator (or takes it pinned, `z`) and runs the generator on z
and the mel; it takes no f0. `wav2mfcc` is the reference's MFCC of a
waveform (`vocoder_utils.wav2mfcc`).
"""

from __future__ import annotations

from typing import Optional

import torch

from bisinger_tpu_torch.models.pwg import ParallelWaveGANGenerator
from bisinger_tpu_torch.vocoders.base_vocoder import BaseVocoder, register_vocoder


@register_vocoder
class PWG(BaseVocoder):
    MODEL = ParallelWaveGANGenerator

    def generate(self, mel, f0=None, generator: Optional[torch.Generator] = None, z=None,
                 seq=None, **_) -> torch.Tensor:
        """mel [B, T, 80] -> wav [B, T * hop]; f0 is not used. Under `seq` it
        runs whole (`generate_whole`)."""
        if seq is not None:
            return self.generate_whole(mel, None, generator, seq, z=z)
        if z is None:
            z = torch.randn((mel.shape[0], mel.shape[1] * self.model.hop), generator=generator,
                            device=mel.device)
        return self.model(z, mel)

    @staticmethod
    def wav2mfcc(wav_fn, hp):
        """A wav file (or array) -> [T, 39] MFCC + deltas."""
        from bisinger_tpu_torch.data.binarizer import load_wav
        from bisinger_tpu_torch.vocoders.vocoder_utils import wav2mfcc

        wav = load_wav(wav_fn, hp["audio_sample_rate"]) if isinstance(wav_fn, str) else wav_fn
        return wav2mfcc(wav, hp)
