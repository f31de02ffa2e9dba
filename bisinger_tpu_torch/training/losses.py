"""Training losses (counterpart of `bisinger_tpu/training/losses.py:26-288`):
the mel l1 and SSIM losses, the MIDI tasks' phone, word and sentence duration
losses (the log-MSE, the mixture head's NLL or the CRF's), the frame-level f0
loss (L1 or L2 on the voiced frames plus the uv logits' BCE) of the
PitchExtractor and of FastSpeech2's pitch predictor, its phone-level f0 loss,
the CWT pitch head's loss, and the energy loss. Every reduction is masked over
static shapes (but the CWT spectrogram's, a plain mean over every element,
padding included, as JAX's); the word-duration loss sums into a fixed
`max_words` segments.

Under data parallelism each loss is this rank's share of the loss over
the global batch, as JAX computes it on the globally sharded array: the
local sum over the global count (a mask's sum over every rank, or every
rank's elements for a plain mean; `parallel.mesh.global_count`,
`global_mean`). The clamp at 1 applies to the global count. The shares sum
over the ranks to the global loss, and so do their gradients; an average
of the ranks' own means would weigh the ranks' frames unequally.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from bisinger_tpu_torch.models.predictors import (
    crf_log_likelihood,
    mog_expected_log_dur,
    mog_log_nll,
)
from bisinger_tpu_torch.parallel.mesh import global_count, global_mean


def weights_nonzero_speech(target):
    """1.0 for frames with any energy, broadcast over the mel bins."""
    mask = (target.abs().sum(-1, keepdim=True) != 0).to(target.dtype)
    return mask.expand_as(target)


def mel_l1_loss(mel_out, target):
    w = weights_nonzero_speech(target)
    return ((mel_out - target).abs() * w).sum() / torch.clamp_min(global_count(w.sum()), 1.0)


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1, img2, window_size: int = 11):
    """Per-pixel SSIM map of [B, T, M] 'images' (reference `ssim.py:330-351`,
    one channel): one 2D convolution with a Gaussian window."""
    win = torch.from_numpy(_gaussian_window(window_size)).to(img1.device)[None, None]
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x[:, None], win, padding=pad)[:, 0]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def mel_ssim_loss(mel_out, target, bias: float = 6.0):
    w = weights_nonzero_speech(target)
    loss = (1.0 - ssim(mel_out + bias, target + bias)) * w
    return loss.sum() / torch.clamp_min(global_count(w.sum()), 1.0)


def parse_mel_loss_spec(spec: str) -> Dict[str, float]:
    """'l1:0.5|ssim:0.5' -> {'l1': 0.5, 'ssim': 0.5}."""
    out = {}
    for part in spec.split("|"):
        if ":" in part:
            name, lbd = part.split(":")
            out[name] = float(lbd)
        else:
            out[part] = 1.0
    return out


def add_mel_loss(mel_out, target, losses: Dict, hp, postfix: str = ""):
    for name, lbd in parse_mel_loss_spec(hp["mel_loss"]).items():
        if name == "l1":
            loss = mel_l1_loss(mel_out, target)
        elif name == "ssim":
            loss = mel_ssim_loss(mel_out, target)
        else:
            raise NotImplementedError(name)
        losses[f"{name}{postfix}"] = loss * lbd


def mel2ph_to_dur(mel2ph, t_txt: int):
    """mel2ph [B, T_mel] -> frames per phone [B, t_txt] (fp32); frame
    indices past t_txt count nowhere."""
    b = mel2ph.shape[0]
    out = torch.zeros((b, t_txt + 2), dtype=torch.float32, device=mel2ph.device)
    idx = mel2ph.long().clamp(max=t_txt + 1)
    out.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    return out[:, 1:t_txt + 1]


def segment_sum(values, segment_ids, num_segments: int):
    """values [B, T] summed into [B, num_segments] by segment_ids [B, T];
    ids >= num_segments are dropped."""
    ids = segment_ids.long().clamp(max=num_segments)
    out = torch.zeros((values.shape[0], num_segments + 1), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add(1, ids, values)[:, :num_segments]


def _masked_mean(x, mask):
    return (x * mask).sum() / torch.clamp_min(global_count(mask.sum()), 1.0)


def add_dur_loss_midi(dur_pred_log, mel2ph, txt_tokens, word_boundary, losses: Dict, hp,
                      crf_transitions=None):
    """Phone, word (summed between word boundaries) and sentence duration
    losses (`losses.py:106-178`, reference `usr/diffsinger_task.py:518-564`).
    The phone term by the head (`dur_loss`): the log-MSE of the [B, T] log
    durations; for the mixture head [B, T, 15] its NLL, the word and sentence
    terms on round-free decodes exp(E[log dur]) - 1; for the CRF head
    [B, T, 32] the NLL of the durations capped at 31 frames (the states)
    under `crf_transitions`, over the tokens, and the states' expectation
    under the softmax of the emissions for the other terms."""
    nonpadding = (txt_tokens != 0).float()
    dur_gt = mel2ph_to_dur(mel2ph, txt_tokens.shape[1]) * nonpadding
    head = hp.get("dur_loss", "mse") if dur_pred_log.ndim == 3 else "mse"
    if head == "mog":
        losses["pdur"] = _masked_mean(mog_log_nll(dur_pred_log, dur_gt), nonpadding) \
            * hp["lambda_ph_dur"]
        dur_pred = torch.clamp_min(torch.exp(mog_expected_log_dur(dur_pred_log)) - 1.0, 0.0)
    elif head == "crf":
        n_states = dur_pred_log.shape[-1]
        tags = torch.clamp(dur_gt.long(), 0, n_states - 1)
        ll = crf_log_likelihood(dur_pred_log, crf_transitions, tags, mask=nonpadding)
        losses["pdur"] = -ll.sum() / torch.clamp_min(global_count(nonpadding.sum()), 1.0) \
            * hp["lambda_ph_dur"]
        states = torch.arange(n_states, dtype=torch.float32, device=dur_pred_log.device)
        dur_pred = (torch.softmax(dur_pred_log, dim=-1) * states).sum(-1)
    else:
        pdur = (dur_pred_log - torch.log(dur_gt + 1.0)) ** 2
        losses["pdur"] = _masked_mean(pdur, nonpadding) * hp["lambda_ph_dur"]
        dur_pred = torch.clamp_min(torch.exp(dur_pred_log) - 1.0, 0.0)
    if hp["lambda_word_dur"] > 0 and word_boundary is not None:
        idx = F.pad(torch.cumsum(word_boundary.long(), dim=1), (1, 0))[:, :-1]
        n_words = hp.get("max_words", 128)
        word_dur_p = segment_sum(dur_pred * nonpadding, idx, n_words)
        word_dur_g = segment_sum(dur_gt * nonpadding, idx, n_words)
        wdur = (torch.log(word_dur_p + 1.0) - torch.log(word_dur_g + 1.0)) ** 2
        losses["wdur"] = _masked_mean(wdur, (word_dur_g > 0).float()) * hp["lambda_word_dur"]
    if hp["lambda_sent_dur"] > 0:
        sent_p = (dur_pred * nonpadding).sum(-1)
        sent_g = dur_gt.sum(-1)
        sdur = global_mean((torch.log(sent_p + 1.0) - torch.log(sent_g + 1.0)) ** 2)
        losses["sdur"] = sdur * hp["lambda_sent_dur"]


def add_dur_loss_sil(dur_pred_log, mel2ph, txt_tokens, is_sil, losses: Dict, hp):
    """The speech variant: words delimited by silence phones
    (`tasks/tts/fs2.py:213-259`); `is_sil` [B, T_txt] float."""
    nonpadding = (txt_tokens != 0).float()
    dur_gt = mel2ph_to_dur(mel2ph, txt_tokens.shape[1]) * nonpadding
    pdur = (dur_pred_log - torch.log(dur_gt + 1.0)) ** 2
    losses["pdur"] = _masked_mean(pdur, nonpadding) * hp["lambda_ph_dur"]
    dur_pred = torch.clamp_min(torch.exp(dur_pred_log) - 1.0, 0.0)
    if hp["lambda_word_dur"] > 0:
        word_id = (torch.cumsum(is_sil, dim=-1) * (1 - is_sil)).long()
        n_words = hp.get("max_words", 128)
        # bucket 0 collects the silences and is dropped
        word_dur_p = segment_sum(dur_pred, word_id, n_words)[:, 1:]
        word_dur_g = segment_sum(dur_gt, word_id, n_words)[:, 1:]
        wdur = (torch.log(word_dur_p + 1.0) - torch.log(word_dur_g + 1.0)) ** 2
        losses["wdur"] = _masked_mean(wdur, (word_dur_g > 0).float()) * hp["lambda_word_dur"]
    if hp["lambda_sent_dur"] > 0:
        sdur = global_mean((torch.log(dur_pred.sum(-1) + 1.0)
                            - torch.log(dur_gt.sum(-1) + 1.0)) ** 2)
        losses["sdur"] = sdur * hp["lambda_sent_dur"]


def binary_cross_entropy_with_logits(logits, labels):
    """max(x, 0) - x * y + log1p(exp(-|x|)), elementwise."""
    return torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def add_f0_loss(pitch_pred, f0, uv, nonpadding, losses: Dict, hp):
    """Frame-level f0 loss (`losses.py:220-240`): with `use_uv`, the uv
    logits' BCE over the non-padding frames (x lambda_uv) and the f0 error on
    the voiced ones only; `pitch_loss` l1 or l2 (x lambda_f0)."""
    if hp["use_uv"]:
        uv_loss = binary_cross_entropy_with_logits(pitch_pred[:, :, 1], uv)
        losses["uv"] = _masked_mean(uv_loss, nonpadding) * hp["lambda_uv"]
        nonpadding = nonpadding * (uv == 0).float()
    f0_pred = pitch_pred[:, :, 0]
    if hp["pitch_loss"] == "l1":
        err = torch.abs(f0_pred - f0)
    elif hp["pitch_loss"] == "l2":
        err = (f0_pred - f0) ** 2
    else:
        raise NotImplementedError(hp["pitch_loss"])
    losses["f0"] = _masked_mean(err, nonpadding) * hp["lambda_f0"]


def add_pitch_loss(ret, batch, losses: Dict, hp):
    """FastSpeech2's pitch loss (`losses.py:243-279`): `pitch_type` "frame"
    as `add_f0_loss` over the frames of mel2ph; "ph", the L1 of the f0 head
    against a phone-level f0 over the tokens; "cwt", the spectrogram's
    `cwt_loss` (l1 or l2, a plain mean) as "C", the uv logit's BCE over the
    frames of mel2ph (`use_uv`) and the L1 of the log-f0 mean and std, each
    x lambda_f0 (uv x lambda_uv)."""
    if hp["pitch_type"] == "cwt":
        err = ret["cwt"][:, :, :10] - batch["cwt_spec"]
        if hp["cwt_loss"] == "l1":
            # |err| with jnp.abs's gradient at 0, +1 (torch's is 0): on the padded
            # frames the head's output and the padded target are both 0
            losses["C"] = global_mean(torch.where(err >= 0, err, -err)) * hp["lambda_f0"]
        elif hp["cwt_loss"] == "l2":
            losses["C"] = global_mean(err ** 2) * hp["lambda_f0"]
        else:
            raise NotImplementedError(f"cwt_loss: {hp['cwt_loss']}")
        if hp["use_uv"]:
            uv_loss = binary_cross_entropy_with_logits(ret["cwt"][:, :, -1], batch["uv"])
            losses["uv"] = _masked_mean(uv_loss, (batch["mel2ph"] != 0).float()) * hp["lambda_uv"]
        for k in ("f0_mean", "f0_std"):
            losses[k] = global_mean((ret[k] - batch[k]).abs()) * hp["lambda_f0"]
        return
    if hp["pitch_type"] == "ph":
        nonpadding = (batch["txt_tokens"] != 0).float()
        err = torch.abs(ret["pitch_pred"][:, :, 0] - batch["f0"])
        losses["f0"] = _masked_mean(err, nonpadding) * hp["lambda_f0"]
        return
    if hp["pitch_type"] != "frame":
        raise NotImplementedError(f"pitch_type={hp['pitch_type']} is not ported")
    add_f0_loss(ret["pitch_pred"], batch["f0"], batch["uv"], (batch["mel2ph"] != 0).float(),
                losses, hp)


def add_energy_loss(energy_pred, energy, losses: Dict, hp):
    """The MSE of the energy head over the frames of non-zero energy
    (`losses.py:282-288`)."""
    nonpadding = (energy != 0).float()
    losses["e"] = _masked_mean((energy_pred - energy) ** 2, nonpadding) * hp["lambda_energy"]
