"""The port's DDPM, DPM-Solver++ and shallow-start samplers against the JAX
package's, on the CPU at the tiny widths of torch_port_helpers (K=40).

Both sides start from the same x and cond_proj, as
tests/test_torch_diffnet.py does for PLMS; DDPM's per-step noise is the
JAX rng's draw at each step (`_scan_ddpm`: split, then draw), and the
shallow start's `q_sample` noise the JAX rng's first draw, both handed to
the port. Bound: the denormalised mel within 1e-3 in fp32 (the suite's
mel bound, tests/test_reference_parity.py:694); measured on the CPU with
this file, 2.1e-6 for DPM-Solver++ over 8 steps and 2.9e-6 for DDPM.

In bf16 the port's K1 rounds where the TPU kernel rounds, and the JAX
side here runs flax's XLA stack, its main path, which rounds elsewhere
(tests/test_torch_diffnet.py: 7.1e-3 of the largest value for one pass of
the stack). DPM-Solver++ over 8 steps against JAX in bf16, measured on
the CPU with this file, the port in bf16 / the port in fp32: mel (spans
+-6) max |difference| 2.3e-2 / 3.3e-2, mean 2.5e-3 / 3.3e-3; bounds max
2.8e-2, mean 2.9e-3, which a port ignoring compute_dtype exceeds.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from bisinger_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion

from torch_port_helpers import VOCAB, hparams, max_err, midi_batch, noisy, t, to_port

B, T, M = 2, 24, 80
DPM_STEPS = 8


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The tiny model's flax parameters, made once (they are fp32 and the
    same for every sampler and compute_dtype), with its inputs: a token
    batch, a start x and a decoder input."""
    jhp, _ = hparams()
    batch = midi_batch(b=B, n_tokens=8, n_frames=T)
    jm = JGaussianDiffusion(hp=jhp, vocab_size=VOCAB)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"], spk_embed=batch["spk_ids"],
        pitch_midi=batch["pitch_midi"], midi_dur=batch["midi_dur"], is_slur=batch["is_slur"],
        lang=batch["lang"], speechsing=batch["speechsing"],
        method=JGaussianDiffusion.init_path))()["params"]
    params = noisy(dict(params), ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    r = np.random.default_rng(4)
    x = r.standard_normal((B, T, M)).astype(np.float32)
    cond = r.standard_normal((B, T, 32)).astype(np.float32)
    return batch, params, x, cond


def _jax_model(**kw):
    jhp, hp = hparams(**kw)
    batch, params, x, cond = _jax_params()
    return jhp, hp, batch, JGaussianDiffusion(hp=jhp, vocab_size=VOCAB), params, x, cond


def _port(tmp_path, hp, params):
    model = to_port(GaussianDiffusion(hp, VOCAB), params, tmp_path)
    calls = []
    real_forward = model.denoise_fn.forward
    model.denoise_fn.forward = lambda *a, **k: calls.append(1) or real_forward(*a, **k)
    return model, calls


def _jax_loop(jm, params, x, cond, loop):
    def run(m, x, cond):
        return m.denorm_spec(loop(m, x, m.denoise_fn.cond_projections(cond)))

    return np.asarray(jax.jit(lambda x, cond: jm.apply({"params": params}, x, cond,
                                                       method=run))(x, cond))


def _port_loop(model, x, cond, loop):
    with torch.no_grad():
        cp = model.denoise_fn.cond_projections(t(cond)).contiguous()
        return model.denorm_spec(loop(model, t(x), cp, model.denoise_fn.stack_weights())).numpy()


def test_ddpm_matches_jax(tmp_path):
    jhp, hp, _, jm, params, x, cond = _jax_model()
    k = hp["K_step"]
    rng = jax.random.PRNGKey(11)
    ref = _jax_loop(jm, params, x, cond, lambda m, x, cp: m.ddpm_sample_loop(x, cp, k, rng))
    draws, key = [], rng
    for _ in range(k):
        key, step_key = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(step_key, x.shape, x.dtype)))
    model, calls = _port(tmp_path, hp, params)
    got = _port_loop(model, x, cond, lambda m, x, cp, st: m.ddpm_sample_loop(
        x, cp, k, st, step_noise=t(np.stack(draws))))
    assert len(calls) == k
    assert np.abs(ref).max() > 1.0
    assert max_err(got, ref) <= 1e-3
    with pytest.raises(ValueError, match="step_noise"):
        model.ddpm_sample_loop(t(x), None, k, step_noise=t(np.stack(draws[:-1])))


@pytest.mark.parametrize("steps", [DPM_STEPS, 3, 2])
def test_dpmpp_matches_jax(tmp_path, steps):
    jhp, hp, _, jm, params, x, cond = _jax_model()
    k = hp["K_step"]
    ref = _jax_loop(jm, params, x, cond, lambda m, x, cp: m.dpmpp_sample_loop(x, cp, k, steps))
    model, calls = _port(tmp_path, hp, params)
    got = _port_loop(model, x, cond,
                     lambda m, x, cp, st: m.dpmpp_sample_loop(x, cp, k, steps, st))
    assert len(calls) == steps == len(model.dpmpp_schedule(k, steps)[0])
    assert max_err(got, ref) <= 1e-3


def test_dpmpp_matches_jax_in_bf16(tmp_path):
    """The module docstring gives the measurement and the bound."""
    jhp, hp, _, jm, params, x, cond = _jax_model(compute_dtype="bfloat16")
    k = hp["K_step"]
    ref = _jax_loop(jm, params, x, cond,
                    lambda m, x, cp: m.dpmpp_sample_loop(x, cp, k, DPM_STEPS))
    model, _ = _port(tmp_path, hp, params)
    got = _port_loop(model, x, cond,
                     lambda m, x, cp, st: m.dpmpp_sample_loop(x, cp, k, DPM_STEPS, st))
    err, mean = max_err(got, ref), float(np.abs(got - ref).mean())
    assert err <= 2.8e-2 and mean <= 2.9e-3, (err, mean)


@pytest.mark.parametrize("sampler", ["plms", "dpmpp", "ddpm"])
def test_shallow_start_matches_jax(tmp_path, sampler):
    """The whole diffusion model from tokens, the start the fs2 mel noised
    to step K-1 (`gaussian_start` off), through each sampler as
    `_dispatch_sampler` picks it; the port counts its denoiser calls."""
    over = dict(gaussian_start=False, dpm_steps=DPM_STEPS,
                diff_sampler="dpmpp" if sampler == "dpmpp" else "plms",
                pndm_speedup=0 if sampler == "ddpm" else 5)
    jhp, hp, batch, jm, params, _, _ = _jax_model(**over)
    rng = jax.random.PRNGKey(5)
    kw = dict(txt_tokens=batch["txt_tokens"], spk_embed=batch["spk_ids"],
              **{k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur", "lang",
                                       "speechsing")})
    ret = jax.jit(lambda mel2ph: jm.apply({"params": params}, mel2ph=mel2ph, infer=True,
                                          rng=rng, rngs={"diffusion": rng}, **kw))(
        batch["mel2ph"])
    rng_start, rng_loop = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(rng_start, (B, T, M)))
    pins = dict(start_noise=t(noise))
    if sampler == "ddpm":
        draws, key = [], rng_loop
        for _ in range(hp["K_step"]):
            key, step_key = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(step_key, (B, T, M))))
        pins["step_noise"] = t(np.stack(draws))
    model, calls = _port(tmp_path, hp, params)
    with torch.no_grad():
        out = model(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]), spk_id=t(batch["spk_ids"]),
                    pitch_midi=t(batch["pitch_midi"]), midi_dur=t(batch["midi_dur"]),
                    is_slur=t(batch["is_slur"]), lang=t(batch["lang"]),
                    speechsing=t(batch["speechsing"]), **pins)
    assert len(calls) == {"plms": 9, "dpmpp": DPM_STEPS, "ddpm": hp["K_step"]}[sampler]
    mel_ref = np.asarray(ret["mel_out"])
    assert np.abs(mel_ref - np.asarray(ret["fs2_mel"])).max() > 1e-2
    assert max_err(out["mel_out"].numpy(), mel_ref) <= 1e-3
    assert max_err(out["fs2_mel"].numpy(), np.asarray(ret["fs2_mel"])) <= 1e-3
