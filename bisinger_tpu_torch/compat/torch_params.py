"""torch state_dict -> flax-named parameter trees for the acoustic models
(the port's copy of `bisinger_tpu/compat/torch_params.py:28-249`), so that
weights trained by the original PyTorch BiSinger load into the port: a
tree goes through `weights.flatten_tree` into `weights.load_flax_params`.

Layout conversions:

  torch nn.Linear  weight [out, in]      -> flax Dense kernel [in, out]
  torch nn.Conv1d  weight [out, in, k]   -> flax Conv  kernel [k, in, out]
  torch nn.Embedding weight [V, D]       -> flax Embed embedding [V, D]
  torch nn.LayerNorm / GroupNorm / BatchNorm weight,bias -> scale,bias
  fairseq in_proj_weight [3D, D]         -> q/k/v Dense kernels [D, D]

Name maps mirror the reference modules:
  FastSpeech2(MIDI)  `train_bisinger/modules/fastspeech/fs2.py:24-94`,
                     `modules/diffsinger_midi/fs2.py:79-107`
  FFT blocks         `modules/fastspeech/tts_modules.py:253-309`,
                     `modules/commons/common_layers.py:598-730`
  DiffNet            `usr/diff/net.py:81-105`
  PitchExtractor     `modules/fastspeech/pe.py:8-134` (its BatchNorm
                     running statistics as a second tree)

The reference checkout's loader (`bisinger_tpu/compat/ref_loader.py`) is
not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np


def _t2n(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def linear(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t2n(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["bias"] = _t2n(sd[f"{name}.bias"])
    return out


def conv1d(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t2n(sd[f"{name}.weight"]).transpose(2, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _t2n(sd[f"{name}.bias"])
    return out


def embedding(sd: Mapping, name: str) -> Dict[str, Any]:
    return {"embed": {"embedding": _t2n(sd[f"{name}.weight"])}}


def norm(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    """LayerNorm/GroupNorm/BatchNorm affine params."""
    return {"scale": _t2n(sd[f"{name}.weight"]), "bias": _t2n(sd[f"{name}.bias"])}


def mha(sd: Mapping, name: str, bias: bool) -> Dict[str, Any]:
    """fairseq-style MultiheadAttention / torch nn.MultiheadAttention
    (both store `in_proj_weight` [3D, D] + `out_proj`)."""
    w = _t2n(sd[f"{name}.in_proj_weight"])
    d = w.shape[1]
    out: Dict[str, Any] = {}
    b = _t2n(sd[f"{name}.in_proj_bias"]) if bias else None
    for i, nm in enumerate(["q_proj", "k_proj", "v_proj"]):
        p = {"kernel": w[i * d : (i + 1) * d].T}
        if b is not None:
            p["bias"] = b[i * d : (i + 1) * d]
        out[nm] = p
    out["out_proj"] = linear(sd, f"{name}.out_proj")
    return out


def _ffn(sd: Mapping, pfx: str, padding: str) -> Dict[str, Any]:
    # SAME: ffn_1 is the Conv1d; LEFT: ffn_1 = Sequential(pad, conv)
    conv_name = f"{pfx}.ffn_1" if padding == "SAME" else f"{pfx}.ffn_1.1"
    return {"Conv_0": conv1d(sd, conv_name), "Dense_0": linear(sd, f"{pfx}.ffn_2")}


def enc_sa_layer(sd: Mapping, pfx: str, padding: str = "SAME") -> Dict[str, Any]:
    """`EncSALayer` (`common_layers.py:664-730`) -> our `EncSALayer`."""
    return {
        "layer_norm1": norm(sd, f"{pfx}.layer_norm1"),
        "self_attn": mha(sd, f"{pfx}.self_attn", bias=False),
        "layer_norm2": norm(sd, f"{pfx}.layer_norm2"),
        "ffn": _ffn(sd, f"{pfx}.ffn", padding),
    }


def fft_blocks(
    sd: Mapping, pfx: str, num_layers: int, padding: str = "SAME",
    use_pos_embed: bool = False, use_last_norm: bool = True,
) -> Dict[str, Any]:
    """`FFTBlocks` (`tts_modules.py:253-309`) -> our `FFTBlocks`."""
    p: Dict[str, Any] = {}
    if use_pos_embed:
        p["pos_embed_alpha"] = _t2n(sd[f"{pfx}.pos_embed_alpha"])
    for i in range(num_layers):
        p[f"layer_{i}"] = enc_sa_layer(sd, f"{pfx}.layers.{i}.op", padding)
    if use_last_norm:
        p["final_ln"] = norm(sd, f"{pfx}.layer_norm")
    return p


def _conv_relu_ln_stack(sd: Mapping, pfx: str, n_layers: int) -> Dict[str, Any]:
    """Duration/pitch predictor conv stacks: Sequential(pad, conv, relu,
    LayerNorm, dropout) per layer (`tts_modules.py:87-97,209-219`)."""
    p: Dict[str, Any] = {}
    for i in range(n_layers):
        p[f"conv_{i}"] = {
            "Conv_0": conv1d(sd, f"{pfx}.conv.{i}.1"),
            "LayerNorm_0": norm(sd, f"{pfx}.conv.{i}.3"),
        }
    p["linear"] = linear(sd, f"{pfx}.linear")
    return p


def duration_predictor(sd: Mapping, pfx: str, n_layers: int) -> Dict[str, Any]:
    return _conv_relu_ln_stack(sd, pfx, n_layers)


def pitch_predictor(sd: Mapping, pfx: str, n_layers: int) -> Dict[str, Any]:
    p = _conv_relu_ln_stack(sd, pfx, n_layers)
    p["pos_embed_alpha"] = _t2n(sd[f"{pfx}.pos_embed_alpha"])
    return p


def esm(sd: Mapping, pfx: str = "esm") -> Dict[str, Any]:
    """`ESM` (`common_layers.py:832-860`)."""
    return {
        "ln1": norm(sd, f"{pfx}.ln1"),
        "ln2": norm(sd, f"{pfx}.ln2"),
        "mh": mha(sd, f"{pfx}.mh", bias=True),
        "ffn1": linear(sd, f"{pfx}.ffn.0"),
        "ffn2": linear(sd, f"{pfx}.ffn.2"),
    }


def fs2_params(sd: Mapping, hp: Mapping, midi: bool = False) -> Dict[str, Any]:
    """FastSpeech2 / FastSpeech2MIDI state_dict -> our flax param tree
    (`modules/fastspeech/fs2.py:24-94` + `modules/diffsinger_midi/fs2.py`)."""
    padding = hp.get("ffn_padding", "SAME")
    p: Dict[str, Any] = {
        "token_embed": embedding(sd, "encoder_embed_tokens"),
        "encoder": fft_blocks(
            sd, "encoder", hp["enc_layers"], padding, use_pos_embed=False
        ),
        "decoder": fft_blocks(
            sd, "decoder", hp["dec_layers"], padding, use_pos_embed=True
        ),
        "mel_out": linear(sd, "mel_out"),
        "dur_predictor": duration_predictor(
            sd, "dur_predictor", hp["dur_predictor_layers"]
        ),
    }
    if hp.get("use_spk_id"):
        p["spk_embed_proj"] = embedding(sd, "spk_embed_proj")
        if hp.get("use_split_spk_id"):
            p["spk_embed_f0"] = embedding(sd, "spk_embed_f0")
            p["spk_embed_dur"] = embedding(sd, "spk_embed_dur")
    elif hp.get("use_spk_embed"):
        p["spk_embed_proj"] = linear(sd, "spk_embed_proj")
    if hp.get("use_pitch_embed"):
        p["pitch_embed"] = embedding(sd, "pitch_embed")
        if hp.get("pitch_type") == "cwt":
            p["cwt_in_proj"] = linear(sd, "cwt_predictor.0")
            p["cwt_predictor"] = pitch_predictor(
                sd, "cwt_predictor.1", hp["predictor_layers"]
            )
            p["cwt_stats_0"] = linear(sd, "cwt_stats_layers.0")
            p["cwt_stats_1"] = linear(sd, "cwt_stats_layers.2")
            p["cwt_stats_2"] = linear(sd, "cwt_stats_layers.4")
        else:
            p["pitch_predictor"] = pitch_predictor(
                sd, "pitch_predictor", hp["predictor_layers"]
            )
    if hp.get("use_energy_embed"):
        p["energy_embed"] = embedding(sd, "energy_embed")
        p["energy_predictor"] = pitch_predictor(
            sd, "energy_predictor", hp["predictor_layers"]
        )
    if midi:
        p["esm"] = esm(sd, "esm")
        p["midi_embed"] = embedding(sd, "midi_embed")
        p["midi_dur_layer"] = linear(sd, "midi_dur_layer")
        p["is_slur_embed"] = embedding(sd, "is_slur_embed")
        p["lang_embed"] = embedding(sd, "lang_embed")
        p["style_embed"] = embedding(sd, "style_embed")
    return p


def diffnet_params(sd: Mapping, hp: Mapping, prefix: str = "") -> Dict[str, Any]:
    """DiffNet state_dict -> our flax tree (`usr/diff/net.py:81-105`)."""
    g = lambda n: f"{prefix}{n}"
    p: Dict[str, Any] = {
        "input_projection": conv1d(sd, g("input_projection")),
        "mlp_0": linear(sd, g("mlp.0")),
        "mlp_1": linear(sd, g("mlp.2")),
        "skip_projection": conv1d(sd, g("skip_projection")),
        "output_projection": conv1d(sd, g("output_projection")),
    }
    for i in range(hp["residual_layers"]):
        rp = g(f"residual_layers.{i}")
        p[f"res_{i}"] = {
            "dilated_conv": conv1d(sd, f"{rp}.dilated_conv"),
            "diffusion_projection": linear(sd, f"{rp}.diffusion_projection"),
            "conditioner_projection": conv1d(sd, f"{rp}.conditioner_projection"),
            "output_projection": conv1d(sd, f"{rp}.output_projection"),
        }
    return p


def gaussian_diffusion_params(sd: Mapping, hp: Mapping) -> Dict[str, Any]:
    """GaussianDiffusion (fs2 conditioner + DiffNet denoiser) state_dict ->
    our tree (`usr/diff/shallow_diffusion_tts.py:71-126`). Schedule buffers
    are recomputed, not copied (pure functions of hparams)."""
    fs2_sd = {k[len("fs2.") :]: v for k, v in sd.items() if k.startswith("fs2.")}
    return {
        "fs2": fs2_params(fs2_sd, hp, midi=bool(hp.get("use_midi"))),
        "denoise_fn": diffnet_params(sd, hp, prefix="denoise_fn."),
    }


def pe_params(
    sd: Mapping, hp: Mapping, conv_layers: int = 2, n_prenet: int = 3
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """PitchExtractor state_dict -> (params, batch_stats)
    (`modules/fastspeech/pe.py:120-134`)."""
    prenet: Dict[str, Any] = {"out_proj": linear(sd, "mel_prenet.out_proj")}
    stats: Dict[str, Any] = {}
    for i in range(n_prenet):
        prenet[f"conv_{i}"] = conv1d(sd, f"mel_prenet.layers.{i}.0")
        bn = f"mel_prenet.layers.{i}.2"
        prenet[f"norm_{i}"] = norm(sd, bn)
        stats[f"norm_{i}"] = {
            "mean": _t2n(sd[f"{bn}.running_mean"]),
            "var": _t2n(sd[f"{bn}.running_var"]),
        }
    p: Dict[str, Any] = {"mel_prenet": prenet}
    if conv_layers > 0:
        enc: Dict[str, Any] = {
            "in_proj": linear(sd, "mel_encoder.in_proj"),
            "out_proj": linear(sd, "mel_encoder.out_proj"),
        }
        for i in range(conv_layers):
            enc[f"conv_{i}"] = conv1d(sd, f"mel_encoder.conv.{i}.conv.conv")
            enc[f"norm_{i}"] = norm(sd, f"mel_encoder.conv.{i}.norm")
        p["mel_encoder"] = enc
    p["pitch_predictor"] = pitch_predictor(sd, "pitch_predictor", 5)
    return p, {"mel_prenet": stats}
