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

Options not ported raise: speaker vectors
(`use_spk_embed`), split speaker ids, the MoG/CRF duration heads,
relative positions, LEFT-padded or non-GELU FFNs. The FFT stacks, the ESM
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
    sinusoidal_positions,
)
from bisinger_tpu_torch.models.predictors import (
    DurationPredictor,
    EnergyPredictor,
    PitchPredictor,
)
from bisinger_tpu_torch.utils.cwt import cwt2f0_norm
from bisinger_tpu_torch.utils.pitch import denorm_f0, f0_to_coarse
from bisinger_tpu_torch.utils.seq import gather_phoneme_states, length_regulator

_UNPORTED = {
    "use_spk_embed": "use_spk_embed=true (speaker vectors) is not ported",
    "use_split_spk_id": "use_split_spk_id=true (per-predictor speaker ids) is not ported",
}


class FastSpeech2(nn.Module):
    def __init__(self, hp: dict, vocab_size: int, out_dims: Optional[int] = None,
                 padding_idx: int = 0, with_decoder: bool = True):
        super().__init__()
        for key, msg in _UNPORTED.items():
            if hp.get(key):
                raise NotImplementedError(msg)
        if hp.get("use_pitch_embed") and hp["pitch_type"] not in ("frame", "ph", "cwt"):
            raise NotImplementedError(f"pitch_type={hp['pitch_type']} is not ported (the port "
                                      "runs frame, ph and cwt)")
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
        self.with_decoder = with_decoder
        if with_decoder:
            self.decoder = FFTBlocks(h, hp["dec_layers"], hp["dec_ffn_kernel_size"],
                                     hp["num_heads"], use_pos_embed=True, dtype=dtype,
                                     dropout=drop)
            self.mel_out = nn.Linear(h, out_dims or hp["audio_num_mel_bins"])
        ph = hp["predictor_hidden"] if hp["predictor_hidden"] > 0 else h
        pdrop = hp.get("predictor_dropout", 0.0)
        self.dur_predictor = DurationPredictor(h, hp["dur_predictor_layers"], ph,
                                               hp["dur_predictor_kernel"], dtype, pdrop)
        if hp["use_spk_id"]:
            self.spk_embed_proj = Embedding(hp["num_spk"] + 1, h)
        if hp.get("use_pitch_embed"):
            self.pitch_embed = Embedding(300, h, padding_idx)
            if hp["pitch_type"] == "cwt":  # the Dense layers compute in fp32, as flax's
                ch = hp["cwt_hidden_size"]
                self.cwt_in_proj = nn.Linear(h, ch)
                self.cwt_predictor = PitchPredictor(
                    ch, hp["predictor_layers"], ph, 10 + (1 if hp["use_uv"] else 0),
                    hp["predictor_kernel"], dtype, pdrop)
                self.cwt_stats_0 = nn.Linear(h, ch)
                self.cwt_stats_1 = nn.Linear(ch, ch)
                self.cwt_stats_2 = nn.Linear(ch, 2)
            else:
                self.pitch_predictor = PitchPredictor(
                    h, hp["predictor_layers"], ph, 2 if hp["pitch_type"] == "frame" else 1,
                    hp["predictor_kernel"], dtype, pdrop)
        if hp.get("use_energy_embed"):
            self.energy_embed = Embedding(256, h, padding_idx)
            self.energy_predictor = EnergyPredictor(h, hp["predictor_layers"], ph, 1,
                                                    hp["predictor_kernel"], dtype, pdrop)

    def encode(self, txt_tokens, **cond):
        """The FFT encoder's output [B, T_txt, H]; `cond` is what the MIDI
        subclass adds to the input (unused here)."""
        x = math.sqrt(self.hp["hidden_size"]) * self.token_embed(txt_tokens)
        return self.encoder(self._positions(x, txt_tokens), txt_tokens == self.padding_idx)

    def _positions(self, x, txt_tokens):
        if self.hp["use_pos_embed"]:
            x = x + sinusoidal_positions((txt_tokens != self.padding_idx).long(),
                                         self.hp["hidden_size"])
        return self.embed_dropout(x)

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
                **cond):
        """-> dict with decoder_inp, mel2ph, (dur), (pitch_pred, f0_denorm),
        (energy_pred), and mel_out unless `skip_decoder`. `cond` holds the
        MIDI subclass's inputs (pitch_midi, midi_dur, is_slur, lang,
        speechsing); the plain model ignores them, as flax's does."""
        hp = self.hp
        ret = {}
        encoder_out = self.encode(txt_tokens, **cond)
        src_padding = txt_tokens == self.padding_idx
        src_nonpadding = (txt_tokens > 0).to(encoder_out.dtype)[:, :, None]
        spk = self.spk_embed_proj(spk_id)[:, None, :] if hp["use_spk_id"] else 0.0
        if mel2ph is None or ref_mels is not None:
            dur_inp = grad_scale((encoder_out + spk) * src_nonpadding,
                                 hp.get("predictor_grad", 1.0))
            ret["dur"] = self.dur_predictor(dur_inp, src_padding)
        if mel2ph is None:
            dur = self.dur_predictor.out2dur(ret["dur"])
            mel2ph = length_regulator(dur, src_padding,
                                      max_frames=max_frames or hp["max_frames"])
        ret["mel2ph"] = mel2ph
        decoder_inp = gather_phoneme_states(encoder_out, mel2ph)
        tgt_nonpadding = (mel2ph > 0).to(encoder_out.dtype)[:, :, None]
        pitch_inp = (decoder_inp + spk) * tgt_nonpadding
        if hp.get("use_pitch_embed"):
            decoder_inp = decoder_inp + self.add_pitch(
                pitch_inp, (encoder_out + spk) * src_nonpadding, f0, uv, mel2ph, ret)
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
