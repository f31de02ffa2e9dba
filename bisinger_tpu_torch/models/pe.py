"""PitchExtractor: mel -> f0 (counterpart of `bisinger_tpu/models/pe.py:21-69`).

Prenet (BatchNorm) -> ConvStacks -> 5-layer PitchPredictor (dropout 0.5)
-> [f0_norm, uv_logit]; `f0_denorm_pred` is 2^f0, zero where unvoiced or
padded. `deterministic=False` (training) runs the predictor's dropout
(masks from the generator `common.set_dropout_generator` hands it) and
normalises with the batch's statistics, updating the running ones; by
default both are off, as flax's `deterministic=True`. The BatchNorm
running statistics come from `pe_batch_stats.npz`; loading raises if they
are missing (weights.load_flax_params leaves nothing unfilled). The convs
run in `compute_dtype` (`pe.py:38`); the norms (their statistics too), the
heads and the outputs are fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from bisinger_tpu_torch.models.common import compute_dtype
from bisinger_tpu_torch.models.predictors import ConvStacks, PitchPredictor, Prenet


class PitchExtractor(nn.Module):
    def __init__(self, hp: dict, n_mel_bins: int = 80):
        super().__init__()
        hidden = 256
        predictor_hidden = hp["predictor_hidden"] if hp["predictor_hidden"] > 0 else hidden
        if hp["pitch_norm"] != "log" or hp["ffn_padding"] != "SAME":
            raise NotImplementedError("the port's PE runs SAME convs and log-normalised f0")
        self.use_uv = hp["pitch_type"] == "frame" and hp["use_uv"]
        dtype = compute_dtype(hp)
        self.mel_prenet = Prenet(n_mel_bins, hidden, dtype=dtype)
        self.mel_encoder = ConvStacks(hidden, n_layers=2, n_chans=hidden, odim=hidden, dtype=dtype)
        self.pitch_predictor = PitchPredictor(hidden, n_layers=5, n_chans=predictor_hidden,
                                              odim=2, kernel_size=hp["predictor_kernel"],
                                              dtype=dtype, dropout=0.5)

    def forward(self, mel, deterministic: bool = True):
        x = self.mel_encoder(self.mel_prenet(mel, deterministic))
        pitch_pred = self.pitch_predictor(x, deterministic)
        f0 = 2.0 ** pitch_pred[:, :, 0]
        if self.use_uv:
            f0 = torch.where(pitch_pred[:, :, 1] > 0, torch.zeros_like(f0), f0)
        f0 = torch.where(mel.abs().sum(-1) == 0, torch.zeros_like(f0), f0)
        return {"pitch_pred": pitch_pred, "f0_denorm_pred": f0}
