"""FastSpeech2MIDI conditioner (counterpart of `bisinger_tpu/models/fs2.py:52-433`).

encoder input = sqrt(H) * token emb + midi emb + midi-dur emb + slur emb
+ ESM(token emb, lang emb) + sinusoidal positions; FFT encoder; duration predictor
and length regulator when no mel2ph is given; frame gather; speaker and
style embeddings; FFT decoder -> `mel_out`. Options the flagship does not
use (pitch/energy embeddings, speaker vectors, split speaker ids, the
MoG/CRF duration heads, relative positions, LEFT-padded or non-GELU FFNs)
are not ported and raise. The FFT stacks, the ESM and the duration
predictor's convs run in `compute_dtype` (`fs2.py:66-115, 387-391`); the
embeddings, the heads and every output stay fp32. In train mode dropout
(`dropout`) runs where flax's does; the duration predictor runs
deterministically, as flax runs it here (see `models/predictors.py`). A
training or validation call passes `ref_mels`: the duration predictor
then runs on the given mel2ph for the duration losses, and `skip_decoder`
stops at the decoder input, as the diffusion stage trains
(`fs2.py:316-356`).
"""

from __future__ import annotations

import math
from typing import Optional

from torch import nn

from bisinger_tpu_torch.models.common import (
    ESM,
    Dropout,
    Embedding,
    FFTBlocks,
    compute_dtype,
    grad_scale,
    sinusoidal_positions,
)
from bisinger_tpu_torch.models.predictors import DurationPredictor
from bisinger_tpu_torch.utils.seq import gather_phoneme_states, length_regulator

_UNPORTED = ("use_pitch_embed", "use_energy_embed", "use_spk_embed", "use_split_spk_id")


class FastSpeech2MIDI(nn.Module):
    def __init__(self, hp: dict, vocab_size: int, out_dims: Optional[int] = None,
                 padding_idx: int = 0):
        super().__init__()
        for key in _UNPORTED:
            if hp.get(key):
                raise NotImplementedError(f"{key}=true is not ported")
        if hp.get("dur_loss", "mse") not in ("mse", "huber"):
            raise NotImplementedError(f"dur_loss={hp['dur_loss']} is not ported")
        if hp["ffn_padding"] != "SAME" or hp["ffn_act"] != "gelu" or (
                hp["use_pos_embed"] and hp.get("rel_pos")):
            raise NotImplementedError("the port runs SAME/gelu FFNs and sinusoidal positions")
        self.hp, self.padding_idx = hp, padding_idx
        h = hp["hidden_size"]
        dtype = compute_dtype(hp)
        drop = hp.get("dropout", 0.0)
        self.token_embed = Embedding(vocab_size, h, padding_idx)
        self.embed_dropout = Dropout(drop)
        self.encoder = FFTBlocks(h, hp["enc_layers"], hp["enc_ffn_kernel_size"],
                                 hp["num_heads"], use_pos_embed=False, dtype=dtype, dropout=drop)
        self.decoder = FFTBlocks(h, hp["dec_layers"], hp["dec_ffn_kernel_size"],
                                 hp["num_heads"], use_pos_embed=True, dtype=dtype, dropout=drop)
        self.mel_out = nn.Linear(h, out_dims or hp["audio_num_mel_bins"])
        ph = hp["predictor_hidden"] if hp["predictor_hidden"] > 0 else h
        self.dur_predictor = DurationPredictor(h, hp["dur_predictor_layers"], ph,
                                               hp["dur_predictor_kernel"], dtype,
                                               hp.get("predictor_dropout", 0.0))
        if hp["use_spk_id"]:
            self.spk_embed_proj = Embedding(hp["num_spk"] + 1, h)
        self.use_lang = hp.get("use_lang_embed", True)
        if self.use_lang:
            self.esm = ESM(h, num_heads=8, cross_batch=hp.get("esm_cross_batch", True),
                           dtype=dtype)
            self.lang_embed = Embedding(2, h)
            self.style_embed = Embedding(3, h)
        self.midi_embed = Embedding(300, h, padding_idx)
        self.midi_dur_layer = nn.Linear(1, h)
        self.is_slur_embed = Embedding(2, h)

    def encode(self, txt_tokens, pitch_midi, midi_dur=None, is_slur=None, lang=None):
        hp, h = self.hp, self.hp["hidden_size"]
        emb = math.sqrt(h) * self.token_embed(txt_tokens)
        x = emb + self.midi_embed(pitch_midi)
        if midi_dur is not None:
            x = x + self.midi_dur_layer(midi_dur[:, :, None])
        if is_slur is not None:
            x = x + self.is_slur_embed(is_slur)
        if self.use_lang:  # the ESM sees the bare token embedding
            x = x + self.esm(emb, self.lang_embed(lang))
        if hp["use_pos_embed"]:
            x = x + sinusoidal_positions((txt_tokens != self.padding_idx).long(), h)
        return self.encoder(self.embed_dropout(x), txt_tokens == self.padding_idx)

    def forward(self, txt_tokens, mel2ph=None, spk_id=None, pitch_midi=None, midi_dur=None,
                is_slur=None, lang=None, speechsing=None, max_frames: Optional[int] = None,
                ref_mels=None, skip_decoder: bool = False):
        ret = {}
        encoder_out = self.encode(txt_tokens, pitch_midi, midi_dur, is_slur, lang)
        src_padding = txt_tokens == self.padding_idx
        src_nonpadding = (txt_tokens > 0).to(encoder_out.dtype)[:, :, None]
        spk = self.spk_embed_proj(spk_id)[:, None, :] if self.hp["use_spk_id"] else 0.0
        if mel2ph is None or ref_mels is not None:
            dur_inp = grad_scale((encoder_out + spk) * src_nonpadding,
                                 self.hp.get("predictor_grad", 1.0))
            ret["dur"] = self.dur_predictor(dur_inp, src_padding)
        if mel2ph is None:
            dur = self.dur_predictor.out2dur(ret["dur"])
            mel2ph = length_regulator(dur, src_padding,
                                      max_frames=max_frames or self.hp["max_frames"])
        ret["mel2ph"] = mel2ph
        decoder_inp = gather_phoneme_states(encoder_out, mel2ph)
        tgt_nonpadding = (mel2ph > 0).to(encoder_out.dtype)[:, :, None]
        style = 0.0
        if self.use_lang and speechsing is not None:
            style = self.style_embed(speechsing)[:, None, :]
        decoder_inp = (decoder_inp + spk + style) * tgt_nonpadding
        ret["decoder_inp"] = decoder_inp
        if skip_decoder:
            return ret
        ret["mel_out"] = self.mel_out(self.decoder(decoder_inp)) * tgt_nonpadding
        return ret
