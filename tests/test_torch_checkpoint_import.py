"""The importers of the reference's PyTorch checkpoints against the JAX
package's, on the CPU at tiny widths.

For each importer a flax parameter tree (seeded numpy draws at the JAX
module's shapes) is inverted here into the reference's state-dict layout:
weight-normed convs as (weight_g, weight_v), transposed-conv kernels with
their taps reversed, fairseq's packed in_proj, the PitchExtractor's
BatchNorm running statistics. That state dict goes through the port's
importer and the JAX package's: the two trees must be equal bit for bit,
the round trip must give the original tree back (exactly; a folded weight
norm within 1e-6 relative, its rounding), and the tree must fill every
parameter of the port's module (`weights.load_flax_params` raises on a
key left over or an entry not filled). `load_torch_checkpoint` reads the
reference's file layouts, and refuses (decision, ROADMAP Queue 3) a file
that needs more than tensors unpickled.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

import bisinger_tpu.compat.torch_params as jtp
import bisinger_tpu.vocoders.torch_import as jti
from bisinger_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from bisinger_tpu.models.hifigan import HifiGanGenerator as JHifiGanGenerator
from bisinger_tpu.models.melgan import MelGanGenerator as JMelGanGenerator
from bisinger_tpu.models.pe import PitchExtractor as JPitchExtractor
from bisinger_tpu.models.pwg import ParallelWaveGANGenerator as JPWGGenerator
from bisinger_tpu_torch.compat import torch_params as ptp
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.melgan import MelGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.models.pwg import ParallelWaveGANGenerator
from bisinger_tpu_torch.vocoders import torch_import as pti
from bisinger_tpu_torch.weights import flatten_tree, load_flax_params

from torch_port_helpers import VOCAB, hparams, midi_batch

KEY = jax.random.PRNGKey(0)


def _draw(shapes, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda sd: r.standard_normal(sd.shape).astype(np.float32), shapes)


def _tree(module, seed, *args, rngs=KEY):
    """Every collection of `module` (params, batch_stats) at its init shapes,
    drawn."""
    return _draw(dict(jax.eval_shape(lambda: module.init(rngs, *args))), seed)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _assert_bitwise(a, b):
    fa, fb = flatten_tree(_np(a)), flatten_tree(_np(b))
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def _assert_round_trip(got, want, folded=()):
    """`got` equals `want` leaf for leaf; keys under a `folded` state-dict
    name (a weight norm the importer folds) within 1e-6 relative."""
    fg, fw = flatten_tree(_np(got)), flatten_tree(_np(want))
    assert set(fg) == set(fw)
    for k, w in fw.items():
        if any(k.startswith(f) for f in folded):
            np.testing.assert_allclose(fg[k], w, rtol=1e-6, atol=1e-7 * np.abs(w).max(),
                                       err_msg=k)
        else:
            assert np.array_equal(fg[k], w), k


# ---- the inverse layouts -------------------------------------------------------
def _normed(sd, name, w):
    """(weight_g, weight_v) of `w` under `name`, v a scaled copy."""
    sd[name + ".weight_v"] = (w * np.float32(1.7)).astype(np.float32)
    sd[name + ".weight_g"] = np.sqrt((w.astype(np.float32) ** 2).sum(
        axis=tuple(range(1, w.ndim)), keepdims=True)).astype(np.float32)


def _weight(sd, name, p, w, wn):
    if wn:
        _normed(sd, name, w)
    else:
        sd[name + ".weight"] = w
    if "bias" in p:
        sd[name + ".bias"] = np.asarray(p["bias"])


def inv_conv(sd, name, p, wn=False):
    _weight(sd, name, p, np.ascontiguousarray(np.asarray(p["kernel"]).transpose(2, 1, 0)), wn)


def inv_conv_transpose(sd, name, p, wn=False):
    _weight(sd, name, p, np.ascontiguousarray(np.asarray(p["kernel"])[::-1].transpose(1, 2, 0)),
            wn)


def inv_linear(sd, name, p):
    sd[name + ".weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[name + ".bias"] = np.asarray(p["bias"])


def inv_norm(sd, name, p):
    sd[name + ".weight"], sd[name + ".bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])


def inv_embed(sd, name, p):
    sd[name + ".weight"] = np.asarray(p["embed"]["embedding"])


def inv_mha(sd, name, p, bias):
    sd[name + ".in_proj_weight"] = np.concatenate(
        [np.asarray(p[q]["kernel"]).T for q in ("q_proj", "k_proj", "v_proj")])
    if bias:
        sd[name + ".in_proj_bias"] = np.concatenate(
            [np.asarray(p[q]["bias"]) for q in ("q_proj", "k_proj", "v_proj")])
    inv_linear(sd, name + ".out_proj", p["out_proj"])


def inv_fft(sd, pfx, p, n_layers, pos=False):
    if pos:
        sd[pfx + ".pos_embed_alpha"] = np.asarray(p["pos_embed_alpha"])
    for i in range(n_layers):
        lp, q = p[f"layer_{i}"], f"{pfx}.layers.{i}.op"
        inv_norm(sd, q + ".layer_norm1", lp["layer_norm1"])
        inv_mha(sd, q + ".self_attn", lp["self_attn"], bias=False)
        inv_norm(sd, q + ".layer_norm2", lp["layer_norm2"])
        inv_conv(sd, q + ".ffn.ffn_1", lp["ffn"]["Conv_0"])
        inv_linear(sd, q + ".ffn.ffn_2", lp["ffn"]["Dense_0"])
    inv_norm(sd, pfx + ".layer_norm", p["final_ln"])


def inv_stack(sd, pfx, p, n_layers, pos=False):
    for i in range(n_layers):
        inv_conv(sd, f"{pfx}.conv.{i}.1", p[f"conv_{i}"]["Conv_0"])
        inv_norm(sd, f"{pfx}.conv.{i}.3", p[f"conv_{i}"]["LayerNorm_0"])
    inv_linear(sd, pfx + ".linear", p["linear"])
    if pos:
        sd[pfx + ".pos_embed_alpha"] = np.asarray(p["pos_embed_alpha"])


def inv_fs2(sd, p, hp, pfx="fs2."):
    inv_embed(sd, pfx + "encoder_embed_tokens", p["token_embed"])
    inv_fft(sd, pfx + "encoder", p["encoder"], hp["enc_layers"])
    inv_fft(sd, pfx + "decoder", p["decoder"], hp["dec_layers"], pos=True)
    inv_linear(sd, pfx + "mel_out", p["mel_out"])
    inv_stack(sd, pfx + "dur_predictor", p["dur_predictor"], hp["dur_predictor_layers"])
    inv_embed(sd, pfx + "spk_embed_proj", p["spk_embed_proj"])
    inv_embed(sd, pfx + "pitch_embed", p["pitch_embed"])
    inv_stack(sd, pfx + "pitch_predictor", p["pitch_predictor"], hp["predictor_layers"],
              pos=True)
    e = p["esm"]
    inv_norm(sd, pfx + "esm.ln1", e["ln1"])
    inv_norm(sd, pfx + "esm.ln2", e["ln2"])
    inv_mha(sd, pfx + "esm.mh", e["mh"], bias=True)
    inv_linear(sd, pfx + "esm.ffn.0", e["ffn1"])
    inv_linear(sd, pfx + "esm.ffn.2", e["ffn2"])
    for name in ("midi_embed", "is_slur_embed", "lang_embed", "style_embed"):
        inv_embed(sd, pfx + name, p[name])
    inv_linear(sd, pfx + "midi_dur_layer", p["midi_dur_layer"])


def inv_diffnet(sd, p, hp, pfx="denoise_fn."):
    inv_conv(sd, pfx + "input_projection", p["input_projection"])
    inv_linear(sd, pfx + "mlp.0", p["mlp_0"])
    inv_linear(sd, pfx + "mlp.2", p["mlp_1"])
    inv_conv(sd, pfx + "skip_projection", p["skip_projection"])
    inv_conv(sd, pfx + "output_projection", p["output_projection"])
    for i in range(hp["residual_layers"]):
        rp, q = p[f"res_{i}"], f"{pfx}residual_layers.{i}"
        inv_conv(sd, q + ".dilated_conv", rp["dilated_conv"])
        inv_linear(sd, q + ".diffusion_projection", rp["diffusion_projection"])
        inv_conv(sd, q + ".conditioner_projection", rp["conditioner_projection"])
        inv_conv(sd, q + ".output_projection", rp["output_projection"])


# ---- the vocoders ----------------------------------------------------------------
HIFI = dict(hop_size=64, upsample_rates=[4, 4, 2, 2], upsample_kernel_sizes=[8, 8, 4, 4],
            upsample_initial_channel=16)


def _hifigan_case(resblock):
    """(port hp, JAX hp, flax tree, reference state dict): the NSF ResBlock1
    generator or the plain ResBlock2 one; weight norm as the reference's
    (every conv but the noise convs)."""
    over = dict(HIFI, use_nsf=resblock == "1") if resblock == "1" else dict(
        HIFI, use_nsf=False, resblock="2", resblock_kernel_sizes=[3, 5],
        resblock_dilation_sizes=[[1, 2], [2, 6]])
    jhp, php = hparams(**over)
    mel = np.zeros((1, 4, 80), np.float32)
    f0 = np.full((1, 4), 200.0, np.float32) if php["use_nsf"] else None
    tree = _tree(JHifiGanGenerator(hp=jhp), 1, mel, f0, rngs={"params": KEY, "nsf": KEY})[
        "params"]
    n_k = len(php["resblock_kernel_sizes"])
    sd = {}
    inv_conv(sd, "conv_pre", tree["conv_pre"], wn=True)
    inv_conv(sd, "conv_post", tree["conv_post"], wn=True)
    for i in range(len(php["upsample_rates"])):
        inv_conv_transpose(sd, f"ups.{i}", tree[f"up_{i}"], wn=True)
        for j in range(n_k):
            blk, q = tree[f"res_{i}_{j}"], f"resblocks.{i * n_k + j}"
            for d in range(len(php["resblock_dilation_sizes"][j])):
                if resblock == "1":
                    inv_conv(sd, f"{q}.convs1.{d}", blk[f"conv1_{d}"], wn=True)
                    inv_conv(sd, f"{q}.convs2.{d}", blk[f"conv2_{d}"], wn=True)
                else:
                    inv_conv(sd, f"{q}.convs.{d}", blk[f"conv_{d}"], wn=True)
        if php["use_nsf"]:
            inv_conv(sd, f"noise_convs.{i}", tree[f"noise_conv_{i}"])
            # the reference's noise norm has no parameters: the importer
            # gives flax's LayerNorm the identity
            tree[f"noise_norm_{i}"] = {"scale": np.ones_like(tree[f"noise_norm_{i}"]["scale"]),
                                       "bias": np.zeros_like(tree[f"noise_norm_{i}"]["bias"])}
    if php["use_nsf"]:
        inv_linear(sd, "m_source.l_linear", tree["m_source"]["merge"])
    return php, jhp, tree, sd


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_importer_matches_jax(resblock):
    php, jhp, tree, sd = _hifigan_case(resblock)
    got = pti.import_hifigan_generator(sd, php)
    _assert_bitwise(got, jti.import_hifigan_generator(sd, jhp))
    _assert_round_trip(got, tree, folded=("conv_pre", "conv_post", "up_", "res_"))
    load_flax_params(HifiGanGenerator(php), flatten_tree(got))


def test_pwg_importer_matches_jax():
    """The PWG generator (weight norm on every conv, the upsample net's
    Conv2d [1, 1, 1, 2s + 1] kernels among them)."""
    fields = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8)
    over = dict(hop_size=8, pwg_upsample_scales=[4, 2], pwg_layers=4, pwg_stacks=2,
                pwg_residual_channels=8, pwg_gate_channels=16, pwg_skip_channels=8)
    jhp, php = hparams(**over)
    tree = _tree(JPWGGenerator(hp=jhp, **fields), 2, np.zeros((1, 32), np.float32),
                 np.zeros((1, 4, 80), np.float32))["params"]
    sd = {}
    inv_conv(sd, "first_conv", tree["first_conv"], wn=True)
    inv_conv(sd, "upsample_net.conv_in", tree["upsample_net"]["conv_in"], wn=True)
    for i in range(2):
        k = np.asarray(tree["upsample_net"]["upsample"][f"conv_{i}_kernel"])
        _normed(sd, f"upsample_net.upsample.up_layers.{2 * i + 1}", k.reshape(1, 1, 1, -1))
    for i in range(4):
        b = tree[f"block_{i}"]
        for ours, theirs in (("conv", "conv"), ("aux_conv", "conv1x1_aux"),
                             ("skip_conv", "conv1x1_skip"), ("out_conv", "conv1x1_out")):
            inv_conv(sd, f"conv_layers.{i}.{theirs}", b[ours], wn=True)
    inv_conv(sd, "last_conv_layers.1", tree["post_conv_1"], wn=True)
    inv_conv(sd, "last_conv_layers.3", tree["post_conv_2"], wn=True)
    got = pti.import_pwg_generator(sd, php)
    _assert_bitwise(got, jti.import_pwg_generator(sd, jhp))
    _assert_round_trip(got, tree, folded=("",))
    load_flax_params(ParallelWaveGANGenerator(php), flatten_tree(got))


def test_melgan_importer_matches_jax():
    """MelGAN's Sequential layout (transposed convs at 3 + 5i, the residual
    stacks' stack.2 / stack.4 / skip_layer), weight norm everywhere."""
    over = dict(melgan_upsample_scales=[3, 2], melgan_channels=16)
    jhp, php = hparams(**over)
    tree = _tree(JMelGanGenerator(hp=jhp), 3, np.zeros((1, 5, 80), np.float32))["params"]
    sd = {}
    inv_conv(sd, "melgan.1", tree["conv_pre"], wn=True)
    for i in range(2):
        inv_conv_transpose(sd, f"melgan.{3 + 5 * i}", tree[f"up_{i}"], wn=True)
        for j in range(3):
            base, r = f"melgan.{4 + 5 * i + j}", tree[f"res_{i}"]
            inv_conv(sd, base + ".stack.2", r[f"conv_{j}"], wn=True)
            inv_conv(sd, base + ".stack.4", r[f"out_{j}"], wn=True)
            inv_conv(sd, base + ".skip_layer", r[f"skip_{j}"], wn=True)
    inv_conv(sd, "melgan.14", tree["conv_post"], wn=True)
    got = pti.import_melgan_generator(sd, php)
    _assert_bitwise(got, jti.import_melgan_generator(sd, jhp))
    _assert_round_trip(got, tree, folded=("",))
    load_flax_params(MelGanGenerator(php), flatten_tree(got))


# ---- the acoustic models -----------------------------------------------------------
def test_gaussian_diffusion_importer_matches_jax():
    """FastSpeech2MIDI (speaker ids, pitch predictor, ESM, lang and style
    embeddings) + DiffNet through `gaussian_diffusion_params`."""
    over = dict(use_midi=True, use_spk_id=True, use_pitch_embed=True, pitch_type="frame")
    jhp, php = hparams(**over)
    batch = midi_batch(b=1, n_tokens=6, n_frames=12)
    shapes = jax.eval_shape(lambda: JGaussianDiffusion(hp=jhp, vocab_size=VOCAB).init(
        {"params": KEY, "diffusion": KEY}, mel2ph=batch["mel2ph"],
        txt_tokens=batch["txt_tokens"], spk_embed=batch["spk_ids"],
        **{k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur", "lang", "speechsing")},
        method=JGaussianDiffusion.init_path)["params"])
    tree = _draw(shapes, 4)
    sd = {}
    inv_fs2(sd, tree["fs2"], php)
    inv_diffnet(sd, tree["denoise_fn"], php)
    got = ptp.gaussian_diffusion_params(sd, php)
    _assert_bitwise(got, jtp.gaussian_diffusion_params(sd, jhp))
    _assert_round_trip(got, tree)
    load_flax_params(GaussianDiffusion(php, VOCAB), flatten_tree(got))


def test_pe_importer_matches_jax():
    """The PitchExtractor: its params and, as a second tree, the BatchNorm
    running statistics."""
    jhp, php = hparams()
    v = _tree(JPitchExtractor(hp=jhp), 5, np.zeros((1, 8, 80), np.float32))
    params, stats = v["params"], v["batch_stats"]
    sd = {}
    pre, q = params["mel_prenet"], "mel_prenet"
    inv_linear(sd, q + ".out_proj", pre["out_proj"])
    for i in range(3):
        inv_conv(sd, f"{q}.layers.{i}.0", pre[f"conv_{i}"])
        inv_norm(sd, f"{q}.layers.{i}.2", pre[f"norm_{i}"])
        sd[f"{q}.layers.{i}.2.running_mean"] = stats["mel_prenet"][f"norm_{i}"]["mean"]
        sd[f"{q}.layers.{i}.2.running_var"] = stats["mel_prenet"][f"norm_{i}"]["var"]
    enc = params["mel_encoder"]
    inv_linear(sd, "mel_encoder.in_proj", enc["in_proj"])
    inv_linear(sd, "mel_encoder.out_proj", enc["out_proj"])
    for i in range(2):
        inv_conv(sd, f"mel_encoder.conv.{i}.conv.conv", enc[f"conv_{i}"])
        inv_norm(sd, f"mel_encoder.conv.{i}.norm", enc[f"norm_{i}"])
    inv_stack(sd, "pitch_predictor", params["pitch_predictor"], 5, pos=True)
    got, got_stats = ptp.pe_params(sd, php)
    ref, ref_stats = jtp.pe_params(sd, jhp)
    _assert_bitwise(got, ref)
    _assert_bitwise(got_stats, ref_stats)
    _assert_round_trip(got, params)
    _assert_round_trip(got_stats, stats)
    load_flax_params(PitchExtractor(php), {**flatten_tree(got), **flatten_tree(got_stats)})


# ---- the checkpoint files ------------------------------------------------------------
@pytest.mark.parametrize("layout", ["model_gen", "generator", "state_dict", "flat_prefixed"])
def test_load_torch_checkpoint_reads_the_reference_layouts(tmp_path, layout):
    """The generator's state dict under each layout the reference writes,
    read by both loaders: equal arrays, and the port's tree equal to JAX's."""
    php, jhp, _, sd = _hifigan_case("1")
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    ckpt = {"model_gen": {"state_dict": {"model_gen": tensors}},
            "generator": {"generator": tensors, "step": 3},
            "state_dict": {"state_dict": tensors},
            "flat_prefixed": {f"model_gen.{k}": v for k, v in tensors.items()}}[layout]
    path = str(tmp_path / "g.ckpt")
    torch.save(ckpt, path)
    got, ref = pti.load_torch_checkpoint(path), jti.load_torch_checkpoint(path)
    assert set(got) == set(ref) == set(sd)
    assert all(np.array_equal(got[k], ref[k]) and np.array_equal(got[k], sd[k]) for k in sd)
    _assert_bitwise(pti.import_hifigan_generator(got, php), jti.import_hifigan_generator(ref, jhp))


def test_decision_checkpoints_are_read_weights_only(tmp_path):
    """Fault 5: JAX's loader unpickles with weights_only=False, so a file
    naming any object runs its constructor; here an argparse.Namespace (as a
    lightning checkpoint's hyperparameters hold) loads there. The port reads
    weights only and refuses such a file with an error that names it."""
    _, _, _, sd = _hifigan_case("2")
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    path = str(tmp_path / "with_hparams.ckpt")
    torch.save({"generator": tensors, "hparams": argparse.Namespace(lr=2e-4)}, path)
    assert set(jti.load_torch_checkpoint(path)) == set(sd)
    with pytest.raises(ValueError, match=r"with_hparams\.ckpt.*weights_only=True"):
        pti.load_torch_checkpoint(path)
