"""FastSpeech2 and FastSpeech2MIDI conditioners (counterpart of
`bisinger_tpu/models/fs2.py:52-433`).

`FastSpeech2` (`fs2.py:52-372`, DiffSinger's PopCS and TTS conditioner):
encoder input = sqrt(H) * token emb + sinusoidal positions; FFT encoder;
duration predictor and length regulator when no mel2ph is given; frame
gather; then the variance adaptors on the frame states:
- `use_pitch_embed`: a pitch predictor on the frames (`pitch_type`
  "frame": f0 and uv logits) or on the phones ("ph": f0), its input's
  gradient scaled by `predictor_grad`; the given f0 (and uv), else the
  predicted, denormalised (`f0_denorm`, 0 on the unvoiced and padding
  frames), quantised to 256 bins and embedded. `pitch_type` "cwt" (the
  TTS configs', `fs2.py:138-156, 234-250`): a 10-scale CWT spectrogram
  (+ uv logit) head on the frames (`cwt_in_proj`, fp32, then
  `cwt_predictor`) and a (mean, std) head on the first phone's state
  (`cwt_stats_0/1/2`, fp32, its gradient unscaled); without a given f0 the
  f0 is the inverse CWT of the head's output with the std scaled by
  `cwt_std_scale`, on the frames (padded frames included, no mel2ph
  gather), and uv the sign of the last logit;
- `use_energy_embed`: an energy predictor on the same input; the given
  energy, else the predicted, quantised to 256 bins and embedded;
then the speaker embedding; FFT decoder -> `mel_out`.

`FastSpeech2MIDI` (`fs2.py:373-433`, the flagship's FFT-Singer) adds midi,
midi-duration and slur embeddings and ESM(token emb, lang emb) to the
encoder input and a style embedding to the decoder input.

The variants of `bisinger_tpu/models/fs2.py`: the speaker a learned
embedding of its id (`use_spk_id`; with `use_split_spk_id` the duration and
pitch predictors get embeddings of their own, `spk_embed_dur` and
`spk_embed_f0`) or a projection of a 256-d speaker vector
(`use_spk_embed`, the Dense `spk_embed_proj`); the duration head by
`dur_loss` (log durations, the 5-Gaussian mixture, or the 32-state CRF,
whose transition matrix `ret["crf_transitions"]` carries to the loss);
ESPnet's relative positions (`rel_pos`: x * sqrt(H) + the reversed-position
table, after `encode` has already scaled the token embedding by sqrt(H), as
`fs2.py:184-195` does, the plain model too); the FFNs' and predictors'
`ffn_padding` (SAME or LEFT, causal) and `ffn_act` (gelu, relu, swish).
`pitch_type` other than frame, ph or cwt raises, as in JAX. The FFT stacks, the ESM
and the predictors' convs run in `compute_dtype` (`fs2.py:66-115,
387-391`); the embeddings, the heads and every output stay fp32. In train
mode dropout (`dropout`) runs where flax's does; the predictors run
deterministically, as flax runs them here (see `models/predictors.py`).
A training or validation call passes `ref_mels`: the duration predictor
then runs on the given mel2ph for the duration losses, and `skip_decoder`
stops at the decoder input, as the diffusion stage trains
(`fs2.py:316-356`). A conditioner built `with_decoder=False` (the offline
diffusion's, whose flax module never runs its decoder and so has no
parameters for it) has no decoder and runs only so.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.common import (
    ESM,
    Dropout,
    Embedding,
    FFTBlocks,
    compute_dtype,
    grad_scale,
    rel_positional_encoding,
    sinusoidal_positions,
)
from bisinger_tpu_torch.models.predictors import (
    DUR_ODIMS,
    DurationPredictor,
    EnergyPredictor,
    PitchPredictor,
)
from bisinger_tpu_torch.utils.cwt import cwt2f0_norm
from bisinger_tpu_torch.utils.pitch import denorm_f0, f0_to_coarse
from bisinger_tpu_torch.utils.seq import gather_phoneme_states, length_regulator

class FastSpeech2(nn.Module):
    def __init__(self, hp: dict, vocab_size: int, out_dims: Optional[int] = None,
                 padding_idx: int = 0, with_decoder: bool = True):
        super().__init__()
        if hp.get("use_pitch_embed") and hp["pitch_type"] not in ("frame", "ph", "cwt"):
            raise NotImplementedError(f"pitch_type={hp['pitch_type']}")  # JAX's refusal
        self.hp, self.padding_idx = hp, padding_idx
        h = hp["hidden_size"]
        dtype = compute_dtype(hp)
        drop = hp.get("dropout", 0.0)
        ffn = dict(padding=hp["ffn_padding"], act=hp["ffn_act"])
        self.token_embed = Embedding(vocab_size, h, padding_idx)
        self.embed_dropout = Dropout(drop)
        self.encoder = FFTBlocks(h, hp["enc_layers"], hp["enc_ffn_kernel_size"],
                                 hp["num_heads"], use_pos_embed=False, dtype=dtype, dropout=drop,
                                 **ffn)
        self.with_decoder = with_decoder
        if with_decoder:
            self.decoder = FFTBlocks(h, hp["dec_layers"], hp["dec_ffn_kernel_size"],
                                     hp["num_heads"], use_pos_embed=True, dtype=dtype,
                                     dropout=drop, **ffn)
            self.mel_out = nn.Linear(h, out_dims or hp["audio_num_mel_bins"])
        ph = hp["predictor_hidden"] if hp["predictor_hidden"] > 0 else h
        pdrop = hp.get("predictor_dropout", 0.0)
        pad = hp["ffn_padding"]
        self.dur_predictor = DurationPredictor(h, hp["dur_predictor_layers"], ph,
                                               hp["dur_predictor_kernel"], dtype, pdrop, pad,
                                               DUR_ODIMS[hp.get("dur_loss", "mse")])
        if hp["use_spk_id"]:
            self.spk_embed_proj = Embedding(hp["num_spk"] + 1, h)
            if hp["use_split_spk_id"]:
                self.spk_embed_f0 = Embedding(hp["num_spk"] + 1, h)
                self.spk_embed_dur = Embedding(hp["num_spk"] + 1, h)
        elif hp["use_spk_embed"]:
            self.spk_embed_proj = nn.Linear(256, h)  # fp32, as flax's Dense
        if hp.get("use_pitch_embed"):
            self.pitch_embed = Embedding(300, h, padding_idx)
            if hp["pitch_type"] == "cwt":  # the Dense layers compute in fp32, as flax's
                ch = hp["cwt_hidden_size"]
                self.cwt_in_proj = nn.Linear(h, ch)
                self.cwt_predictor = PitchPredictor(
                    ch, hp["predictor_layers"], ph, 10 + (1 if hp["use_uv"] else 0),
                    hp["predictor_kernel"], dtype, pdrop, pad)
                self.cwt_stats_0 = nn.Linear(h, ch)
                self.cwt_stats_1 = nn.Linear(ch, ch)
                self.cwt_stats_2 = nn.Linear(ch, 2)
            else:
                self.pitch_predictor = PitchPredictor(
                    h, hp["predictor_layers"], ph, 2 if hp["pitch_type"] == "frame" else 1,
                    hp["predictor_kernel"], dtype, pdrop, pad)
        if hp.get("use_energy_embed"):
            self.energy_embed = Embedding(256, h, padding_idx)
            self.energy_predictor = EnergyPredictor(h, hp["predictor_layers"], ph, 1,
                                                    hp["predictor_kernel"], dtype, pdrop, pad)

    def encode(self, txt_tokens, **cond):
        """The FFT encoder's output [B, T_txt, H]; `cond` is what the MIDI
        subclass adds to the input (unused here)."""
        x = math.sqrt(self.hp["hidden_size"]) * self.token_embed(txt_tokens)
        return self.encoder(self._positions(x, txt_tokens), txt_tokens == self.padding_idx)

    def _positions(self, x, txt_tokens):
        h = self.hp["hidden_size"]
        if self.hp["use_pos_embed"] and self.hp.get("rel_pos"):
            # ESPnet's RelPositionalEncoding scales x by sqrt(H) itself
            x = x * math.sqrt(h) + rel_positional_encoding(x.shape[1], h).to(x.device)
        elif self.hp["use_pos_embed"]:
            x = x + sinusoidal_positions((txt_tokens != self.padding_idx).long(), h)
        return self.embed_dropout(x)

    def speaker(self, spk_id=None, spk_embed=None, spk_dur_id=None, spk_f0_id=None):
        """The speaker terms (all, duration predictor's, pitch predictor's),
        each [B, 1, H] or 0 (`fs2.py:277-293`): an embedding of the id, with
        `use_split_spk_id` the predictors' own embeddings of their ids
        (default the speaker's), or the projected speaker vector."""
        hp = self.hp
        if hp["use_spk_id"]:
            e = self.spk_embed_proj(spk_id)[:, None, :]
            if not hp["use_split_spk_id"]:
                return e, e, e
            return (e, self.spk_embed_dur(spk_id if spk_dur_id is None else spk_dur_id)[:, None],
                    self.spk_embed_f0(spk_id if spk_f0_id is None else spk_f0_id)[:, None])
        if hp["use_spk_embed"]:
            e = self.spk_embed_proj(spk_embed)[:, None, :]
            return e, e, e
        return 0.0, 0.0, 0.0

    def style(self, speechsing=None, **unused):
        return 0.0

    def add_pitch(self, pitch_inp, pitch_inp_ph, f0, uv, mel2ph, ret):
        """The pitch embedding of the frames (`fs2.py:219-265`)."""
        hp = self.hp
        f0_kw = dict(f0_mean=hp.get("f0_mean") or 0.0, f0_std=hp.get("f0_std") or 1.0,
                     use_uv=hp["use_uv"])
        if hp["pitch_type"] == "ph":
            ret["pitch_pred"] = pred = self.pitch_predictor(
                grad_scale(pitch_inp_ph, hp["predictor_grad"]))
            if f0 is None:
                f0 = pred[:, :, 0]
            ret["f0_denorm"] = f0_denorm = denorm_f0(f0, None, hp["pitch_norm"], **f0_kw)
            pitch = F.pad(f0_to_coarse(f0_denorm), (1, 0))  # [B, 1 + T_txt]
            return self.pitch_embed(torch.gather(pitch, 1, mel2ph.long()))
        if hp["pitch_type"] == "cwt":
            ret["cwt"] = cwt_out = self.cwt_predictor(
                self.cwt_in_proj(grad_scale(pitch_inp, hp["predictor_grad"])))
            stats = F.relu(self.cwt_stats_0(pitch_inp_ph[:, 0, :]))
            stats = self.cwt_stats_2(F.relu(self.cwt_stats_1(stats)))  # [B, 2]
            mean = ret["f0_mean"] = stats[:, 0]
            std = ret["f0_std"] = stats[:, 1]
            if f0 is None:
                f0 = cwt2f0_norm(cwt_out[:, :, :10], mean, std * hp["cwt_std_scale"], mel2ph,
                                 hp["pitch_norm"], hp["use_uv"])
                if hp["use_uv"]:
                    uv = (cwt_out[:, :, -1] > 0).to(cwt_out.dtype)
            ret["f0_denorm"] = f0_denorm = denorm_f0(f0, uv, hp["pitch_norm"], **f0_kw)
            return self.pitch_embed(f0_to_coarse(f0_denorm))
        ret["pitch_pred"] = pred = self.pitch_predictor(
            grad_scale(pitch_inp, hp["predictor_grad"]))
        if f0 is None:
            f0 = pred[:, :, 0]
        if hp["use_uv"] and uv is None:
            uv = (pred[:, :, 1] > 0).to(pred.dtype)
        ret["f0_denorm"] = f0_denorm = denorm_f0(f0, uv, hp["pitch_norm"],
                                                 pitch_padding=mel2ph == 0, **f0_kw)
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def add_energy(self, pitch_inp, energy, ret):
        """The energy embedding of the frames (`fs2.py:267-275`)."""
        ret["energy_pred"] = pred = self.energy_predictor(
            grad_scale(pitch_inp, self.hp["predictor_grad"]))[:, :, 0]
        if energy is None:
            energy = pred
        ids = torch.clamp(torch.floor(energy * 256 / 4), 0, 255).long()
        return self.energy_embed(ids)

    def forward(self, txt_tokens, mel2ph=None, spk_id=None, f0=None, uv=None, energy=None,
                max_frames: Optional[int] = None, ref_mels=None, skip_decoder: bool = False,
                spk_embed=None, spk_dur_id=None, spk_f0_id=None, **cond):
        """-> dict with decoder_inp, mel2ph, (dur, crf_transitions),
        (pitch_pred, f0_denorm), (energy_pred), and mel_out unless
        `skip_decoder`. The speaker is `spk_id` [B] (`use_spk_id`; with
        `use_split_spk_id` also `spk_dur_id`, `spk_f0_id`) or the vector
        `spk_embed` [B, 256] (`use_spk_embed`). `cond` holds the MIDI
        subclass's inputs (pitch_midi, midi_dur, is_slur, lang, speechsing);
        the plain model ignores them, as flax's does."""
        hp = self.hp
        ret = {}
        encoder_out = self.encode(txt_tokens, **cond)
        src_padding = txt_tokens == self.padding_idx
        src_nonpadding = (txt_tokens > 0).to(encoder_out.dtype)[:, :, None]
        spk, spk_dur, spk_f0 = self.speaker(spk_id, spk_embed, spk_dur_id, spk_f0_id)
        if mel2ph is None or ref_mels is not None:
            dur_inp = grad_scale((encoder_out + spk_dur) * src_nonpadding,
                                 hp.get("predictor_grad", 1.0))
            ret["dur"] = self.dur_predictor(dur_inp, src_padding)
            if self.dur_predictor.odims == 32:
                ret["crf_transitions"] = self.dur_predictor.crf_transitions
        if mel2ph is None:
            dur = self.dur_predictor.out2dur(ret["dur"], padding=src_padding)
            mel2ph = length_regulator(dur, src_padding,
                                      max_frames=max_frames or hp["max_frames"])
        ret["mel2ph"] = mel2ph
        decoder_inp = gather_phoneme_states(encoder_out, mel2ph)
        tgt_nonpadding = (mel2ph > 0).to(encoder_out.dtype)[:, :, None]
        pitch_inp = (decoder_inp + spk_f0) * tgt_nonpadding
        if hp.get("use_pitch_embed"):
            decoder_inp = decoder_inp + self.add_pitch(
                pitch_inp, (encoder_out + spk_f0) * src_nonpadding, f0, uv, mel2ph, ret)
        if hp.get("use_energy_embed"):
            decoder_inp = decoder_inp + self.add_energy(pitch_inp, energy, ret)
        decoder_inp = (decoder_inp + spk + self.style(**cond)) * tgt_nonpadding
        ret["decoder_inp"] = decoder_inp
        if skip_decoder:
            return ret
        if not self.with_decoder:
            raise ValueError("this conditioner was built without its decoder")
        ret["mel_out"] = self.mel_out(self.decoder(decoder_inp)) * tgt_nonpadding
        return ret


class FastSpeech2MIDI(FastSpeech2):
    """BiSinger's FFT-Singer: midi, midi-duration and slur embeddings and the
    ESM on the encoder input, the style embedding on the decoder input
    (`use_lang_embed`)."""

    def __init__(self, hp: dict, vocab_size: int, out_dims: Optional[int] = None,
                 padding_idx: int = 0, with_decoder: bool = True):
        super().__init__(hp, vocab_size, out_dims, padding_idx, with_decoder)
        h = hp["hidden_size"]
        self.use_lang = hp.get("use_lang_embed", True)
        if self.use_lang:
            self.esm = ESM(h, num_heads=8, cross_batch=hp.get("esm_cross_batch", True),
                           dtype=compute_dtype(hp))
            self.lang_embed = Embedding(2, h)
            self.style_embed = Embedding(3, h)
        self.midi_embed = Embedding(300, h, padding_idx)
        self.midi_dur_layer = nn.Linear(1, h)
        self.is_slur_embed = Embedding(2, h)

    def encode(self, txt_tokens, pitch_midi=None, midi_dur=None, is_slur=None, lang=None,
               **unused):
        emb = math.sqrt(self.hp["hidden_size"]) * self.token_embed(txt_tokens)
        x = emb + self.midi_embed(pitch_midi)
        if midi_dur is not None:
            x = x + self.midi_dur_layer(midi_dur[:, :, None])
        if is_slur is not None:
            x = x + self.is_slur_embed(is_slur)
        if self.use_lang:  # the ESM sees the bare token embedding
            x = x + self.esm(emb, self.lang_embed(lang))
        return self.encoder(self._positions(x, txt_tokens), txt_tokens == self.padding_idx)

    def style(self, speechsing=None, **unused):
        if self.use_lang and speechsing is not None:
            return self.style_embed(speechsing)[:, None, :]
        return 0.0
