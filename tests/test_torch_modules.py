"""The port's conditioner modules and PitchExtractor against the JAX
package, on the CPU at small widths, plus the weight loader and config.

Tolerances: 1e-4 abs on module outputs (fp32 on both sides; summation
order differs); PE f0 within 1 Hz, the bound of
tests/test_reference_parity.py:719 (f0 is 2^x of the head, in Hz).
"""

import jax
import numpy as np
import pytest
import torch

import bisinger_tpu.models.common as jcommon
from bisinger_tpu.models.fs2 import FastSpeech2MIDI as JFastSpeech2MIDI
from bisinger_tpu.models.pe import PitchExtractor as JPitchExtractor
from bisinger_tpu.models.predictors import DurationPredictor as JDurationPredictor
from bisinger_tpu.utils.seq import length_regulator as j_length_regulator
from bisinger_tpu_torch import resolve_device
from bisinger_tpu_torch.config import DEFAULTS, load_hparams_json, make_hparams
from bisinger_tpu_torch.models.common import ESM, FFTBlocks
from bisinger_tpu_torch.models.fs2 import FastSpeech2MIDI
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.models.predictors import DurationPredictor
from bisinger_tpu_torch.utils.seq import length_regulator
from bisinger_tpu_torch.weights import load_flax_params

from torch_port_helpers import VOCAB, hparams, max_err, midi_batch, t, to_port

H = 32


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("cross_batch", [True, False])
def test_esm_matches(tmp_path, cross_batch):
    eo, lp = _x(3, 5, H, seed=1), _x(3, 5, H, seed=2)
    jm = jcommon.ESM(hidden_size=H, num_heads=8, cross_batch=cross_batch)
    params = jm.init(jax.random.PRNGKey(0), eo, lp)["params"]
    ref = np.asarray(jm.apply({"params": params}, eo, lp))
    m = to_port(ESM(H, 8, cross_batch), params, tmp_path)
    with torch.no_grad():
        got = m(t(eo), t(lp)).numpy()
    assert max_err(got, ref) <= 1e-4
    if cross_batch:  # attends across the batch: row 0 reads row 2's language keys
        lp2 = lp.copy()
        lp2[2] = _x(5, H, seed=9)
        with torch.no_grad():
            assert max_err(m(t(eo), t(lp2)).numpy()[0], got[0]) > 1e-3


@pytest.mark.parametrize("use_pos_embed", [True, False])
def test_fft_blocks_match(tmp_path, use_pos_embed):
    x = _x(2, 7, H, seed=3)
    pad = np.zeros((2, 7), bool)
    pad[1, 5:] = True
    x[1, 5:] = 0.0
    jm = jcommon.FFTBlocks(hidden_size=H, num_layers=2, ffn_kernel_size=3, num_heads=2,
                           use_pos_embed=use_pos_embed, dropout=0.0)
    params = jm.init(jax.random.PRNGKey(1), x, pad)["params"]
    ref = np.asarray(jm.apply({"params": params}, x, pad))
    m = to_port(FFTBlocks(H, 2, 3, num_heads=2, use_pos_embed=use_pos_embed), params, tmp_path)
    with torch.no_grad():
        got = m(t(x), t(pad)).numpy()
        got_inferred = m(t(x)).numpy()  # padding read from all-zero frames
    assert max_err(got, ref) <= 1e-4
    assert max_err(got_inferred, np.asarray(jm.apply({"params": params}, x))) <= 1e-4


def test_duration_predictor_matches(tmp_path):
    x = _x(2, 6, H, seed=4)
    pad = np.zeros((2, 6), bool)
    pad[0, 4:] = True
    jm = JDurationPredictor(n_layers=2, n_chans=H, kernel_size=3)
    params = jm.init(jax.random.PRNGKey(2), x, pad)["params"]
    ref = jm.apply({"params": params}, x, pad)
    m = to_port(DurationPredictor(H, 2, H, 3), params, tmp_path)
    with torch.no_grad():
        got = m(t(x), t(pad))
    assert max_err(got.numpy(), ref) <= 1e-4
    ref_dur = np.asarray(jm.apply({"params": params}, ref, method=JDurationPredictor.out2dur))
    np.testing.assert_array_equal(m.out2dur(got).numpy(), ref_dur)


def test_length_regulator_matches():
    dur = np.array([[2, 0, 3, 1, 4], [1, 1, 1, 0, 0]], np.int64)
    pad = np.array([[0, 0, 0, 0, 1], [0, 0, 0, 1, 1]], bool)
    for max_frames in (4, 12):
        ref = np.asarray(j_length_regulator(dur, pad, max_frames=max_frames))
        got = length_regulator(t(dur), t(pad), max_frames=max_frames).numpy()
        np.testing.assert_array_equal(got, ref)


def _fs2_pair(tmp_path, batch):
    jhp, hp = hparams()
    jm = JFastSpeech2MIDI(hp=jhp, vocab_size=VOCAB)
    kw = {k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur", "lang", "speechsing")}
    params = jm.init(jax.random.PRNGKey(3), batch["txt_tokens"], mel2ph=batch["mel2ph"],
                     spk_embed=batch["spk_ids"], **kw)["params"]
    # a fresh duration head predicts ~0 frames; bias it to ~8 frames a token
    params = dict(params)
    lin = params["dur_predictor"]["linear"]
    lin["bias"] = np.asarray(lin["bias"]) + 2.2
    m = to_port(FastSpeech2MIDI(hp, VOCAB), params, tmp_path)
    return jm, params, m, kw


def test_fs2_given_mel2ph_matches(tmp_path):
    batch = midi_batch(b=3, n_tokens=8, n_frames=30)
    jm, params, m, kw = _fs2_pair(tmp_path, batch)
    ref = jm.apply({"params": params}, batch["txt_tokens"], mel2ph=batch["mel2ph"],
                   spk_embed=batch["spk_ids"], **kw)
    with torch.no_grad():
        got = m(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]), spk_id=t(batch["spk_ids"]),
                **{k: t(v) for k, v in kw.items()})
    assert max_err(got["decoder_inp"].numpy(), ref["decoder_inp"]) <= 1e-4
    assert max_err(got["mel_out"].numpy(), ref["mel_out"]) <= 1e-4


def test_fs2_predicted_durations_match(tmp_path):
    batch = midi_batch(b=2, n_tokens=8, n_frames=30, seed=1)
    jm, params, m, kw = _fs2_pair(tmp_path, batch)
    ref = jm.apply({"params": params}, batch["txt_tokens"], mel2ph=None,
                   spk_embed=batch["spk_ids"], max_frames=40, **kw)
    with torch.no_grad():
        got = m(t(batch["txt_tokens"]), spk_id=t(batch["spk_ids"]), max_frames=40,
                **{k: t(v) for k, v in kw.items()})
    assert max_err(got["dur"].numpy(), ref["dur"]) <= 1e-4
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))
    assert (got["mel2ph"].numpy() > 0).sum() > 20
    assert max_err(got["mel_out"].numpy(), ref["mel_out"]) <= 1e-4


def test_pitch_extractor_matches(tmp_path):
    jhp, hp = hparams()
    mel = _x(2, 24, 80, seed=5)
    mel[1, 20:] = 0.0  # padded frames read f0 = 0
    jm = JPitchExtractor(hp=jhp)
    variables = jm.init(jax.random.PRNGKey(4), mel)
    r = np.random.default_rng(6)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for norm in stats["mel_prenet"].values():
        norm["mean"] = r.normal(0.0, 0.5, norm["mean"].shape).astype(np.float32)
        norm["var"] = r.uniform(0.5, 2.0, norm["var"].shape).astype(np.float32)
    ref = jm.apply({"params": variables["params"], "batch_stats": stats}, mel)
    m = to_port(PitchExtractor(hp), variables["params"], tmp_path, extra=stats)
    with torch.no_grad():
        got = m(t(mel))
    assert max_err(got["pitch_pred"].numpy(), ref["pitch_pred"]) <= 1e-4
    f0, f0_ref = got["f0_denorm_pred"].numpy(), np.asarray(ref["f0_denorm_pred"])
    assert (f0[1, 20:] == 0).all() and (f0_ref > 0).any()
    assert max_err(f0, f0_ref) <= 1.0


def test_loader_rejects_unused_missing_and_misshaped_keys(tmp_path):
    jm = JDurationPredictor(n_layers=1, n_chans=H, kernel_size=3)
    x = _x(1, 4, H)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    flat = {"conv_0/Conv_0/kernel": np.asarray(params["conv_0"]["Conv_0"]["kernel"]),
            "conv_0/Conv_0/bias": np.asarray(params["conv_0"]["Conv_0"]["bias"]),
            "conv_0/LayerNorm_0/scale": np.ones(H, np.float32),
            "conv_0/LayerNorm_0/bias": np.zeros(H, np.float32),
            "linear/kernel": np.asarray(params["linear"]["kernel"]),
            "linear/bias": np.asarray(params["linear"]["bias"])}
    load_flax_params(DurationPredictor(H, 1, H, 3), flat)
    with pytest.raises(KeyError, match="maps onto nothing"):
        load_flax_params(DurationPredictor(H, 1, H, 3), {**flat, "extra/kernel": flat["linear/kernel"]})
    with pytest.raises(KeyError, match="not filled"):
        load_flax_params(DurationPredictor(H, 1, H, 3),
                         {k: v for k, v in flat.items() if k != "linear/bias"})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(DurationPredictor(H, 1, H, 3), {**flat, "linear/bias": np.zeros(2)})


def test_config_reads_flagship_json():
    hp = load_hparams_json("artifacts/flagship/hparams_diff.json", {"K_step": 10})
    assert hp["residual_layers"] == 20 and hp["rel_pos"] is False and hp["K_step"] == 10
    over = make_hparams({"spec_min": [0.0]})
    over["resblock_kernel_sizes"].append(99)
    assert DEFAULTS["resblock_kernel_sizes"] == [3, 7, 11]


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
