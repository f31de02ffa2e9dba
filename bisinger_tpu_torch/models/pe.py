"""PitchExtractor: mel -> f0 (counterpart of `bisinger_tpu/models/pe.py:21-69`).

Prenet (BatchNorm) -> ConvStacks (`conv_layers`, default 2; none at 0) ->
5-layer PitchPredictor (dropout 0.5, its convs `ffn_padding`: SAME or LEFT) ->
[f0_norm, uv_logit]; `f0_denorm_pred` is f0 denormalised by `pitch_norm` as
JAX's PE calls `denorm_f0` (`pe.py:59-68`: no f0_mean or f0_std passed, so
"standard" gives f0 * 1 + 0; "log" 2^f0), zero where unvoiced (`pitch_type`
frame with `use_uv`) or padded. `deterministic=False` (training) runs the
predictor's dropout (masks from the generator `common.set_dropout_generator`
hands it) and normalises with the batch's statistics, updating the running
ones; by default both are off, as flax's `deterministic=True`. The BatchNorm
running statistics come from `pe_batch_stats.npz`; loading raises if they are
missing (weights.load_flax_params leaves nothing unfilled). The convs run in
`compute_dtype` (`pe.py:38`); the norms (their statistics too), the heads and
the outputs are fp32.
"""

from __future__ import annotations

from torch import nn

from bisinger_tpu_torch.models.common import compute_dtype
from bisinger_tpu_torch.models.predictors import ConvStacks, PitchPredictor, Prenet
from bisinger_tpu_torch.utils.pitch import denorm_f0


class PitchExtractor(nn.Module):
    def __init__(self, hp: dict, n_mel_bins: int = 80, conv_layers: int = 2):
        super().__init__()
        hidden = 256
        predictor_hidden = hp["predictor_hidden"] if hp["predictor_hidden"] > 0 else hidden
        self.hp = hp
        self.use_uv = hp["pitch_type"] == "frame" and hp["use_uv"]
        dtype = compute_dtype(hp)
        self.mel_prenet = Prenet(n_mel_bins, hidden, dtype=dtype)
        if conv_layers > 0:
            self.mel_encoder = ConvStacks(hidden, n_layers=conv_layers, n_chans=hidden,
                                          odim=hidden, dtype=dtype)
        self.pitch_predictor = PitchPredictor(hidden, n_layers=5, n_chans=predictor_hidden,
                                              odim=2, kernel_size=hp["predictor_kernel"],
                                              dtype=dtype, dropout=0.5,
                                              padding=hp["ffn_padding"])

    def forward(self, mel, deterministic: bool = True):
        x = self.mel_prenet(mel, deterministic)
        if hasattr(self, "mel_encoder"):
            x = self.mel_encoder(x)
        pitch_pred = self.pitch_predictor(x, deterministic)
        uv = (pitch_pred[:, :, 1] > 0).float() if self.use_uv else None
        f0 = denorm_f0(pitch_pred[:, :, 0], uv, self.hp["pitch_norm"], use_uv=self.hp["use_uv"],
                       pitch_padding=mel.abs().sum(-1) == 0)
        return {"pitch_pred": pitch_pred, "f0_denorm_pred": f0}
