"""Duration <-> frame maps (counterpart of `bisinger_tpu/utils/seq.py:24-86`).

The frame budget `max_frames` is fixed by the caller, as in the
reference; frames past it are dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def length_regulator(dur, dur_padding=None, alpha: float = 1.0, max_frames: int = None):
    """dur [B, T_txt] -> mel2ph [B, max_frames] (0 = padding, else phone
    index + 1), the cumsum/mask contract of `seq.py:24-49`."""
    if max_frames is None:
        raise ValueError("max_frames is required")
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    dur = torch.round(dur.float() * alpha).long()
    if dur_padding is not None:
        dur = dur * (1 - dur_padding.long())
    token_idx = torch.arange(1, dur.shape[1] + 1, device=dur.device)[None, :, None]
    dur_cumsum = torch.cumsum(dur, dim=1)
    dur_cumsum_prev = F.pad(dur_cumsum, (1, 0))[:, :-1]
    pos_idx = torch.arange(max_frames, device=dur.device)[None, None, :]
    token_mask = (pos_idx >= dur_cumsum_prev[:, :, None]) & (pos_idx < dur_cumsum[:, :, None])
    return (token_idx * token_mask.long()).sum(dim=1)


def gather_phoneme_states(encoder_out, mel2ph):
    """encoder_out [B, T_txt, H], mel2ph [B, T_mel] -> [B, T_mel, H];
    mel2ph == 0 reads zeros."""
    padded = F.pad(encoder_out, (0, 0, 1, 0))
    idx = mel2ph.long()[:, :, None].expand(-1, -1, encoder_out.shape[-1])
    return torch.gather(padded, 1, idx)


def make_positions(tokens, padding_idx: int = 0):
    """Position ids from padding_idx + 1; padding gets padding_idx."""
    mask = (tokens != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx
