"""One rank of the port's sequence- and pipeline-parallel runs in
tests/test_torch_sequence_parallel.py and tests/test_torch_pipe_parallel.py,
on the CPU over gloo. It imports torch, numpy and the port only (no JAX),
reads its rank from RANK and WORLD_SIZE, and joins the group through the
file named by `--init`:

    python tests/torch_sp_worker.py SPEC.json --init file:///...

SPEC's "mesh" is ["seq", num_seq, num_data] or ["pipe", num_pipe,
num_data]; each of its "cases" runs on the mesh and this rank writes what
it holds of each case's result to <out>/rank<R>.npz: under `seq` its rows'
core frames (or samples), under `pipe` the whole result (every rank holds
it).
"""

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from bisinger_tpu_torch.config import load_hparams_json
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.parallel import pipeline, sequence
from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask
from bisinger_tpu_torch.vocoders.hifigan import HifiGAN
from bisinger_tpu_torch.weights import load_flax_params, load_npz

torch.set_num_threads(1)


def _np(path):
    return {k: torch.as_tensor(v) for k, v in np.load(path).items()}


@contextlib.contextmanager
def halo_zero():
    """Every module's halo 0: the case that must miss its bound."""
    real = sequence.halo_for
    sequence.halo_for = lambda hp, module: 0
    try:
        yield
    finally:
        sequence.halo_for = real


def synthesizer(case):
    """SVSInferTorch from the cases' modules: the diffusion model, the PE
    and the NSF generator (its own hparams), on the CPU."""
    from bisinger_tpu_torch.inference.pipeline import SVSInferTorch

    parts = {}
    for name, cls in (("model", None), ("pe", PitchExtractor), ("vocoder", HifiGanGenerator)):
        hp = load_hparams_json(case[f"{name}_hp"])
        module = GaussianDiffusion(hp, case["vocab"], 80) if cls is None else cls(hp)
        load_flax_params(module, load_npz(case[f"{name}_params"]))
        parts[name] = (hp, module)
    return SVSInferTorch(parts["model"][0], parts["model"][1], parts["pe"][1],
                         parts["vocoder"][1], "cpu", voc_hp=parts["vocoder"][0])


def seq_case(case, mesh):
    hp = load_hparams_json(case["hp"])
    kind = case["kind"]
    if kind == "uneven":  # T % seq != 0 raises
        try:
            sequence.time_spec(mesh.size * 16 + 1, mesh)
        except ValueError as e:
            return np.array(str(e))
        return np.array("")
    data = _np(case["inputs"])
    pins = {k[4:]: v for k, v in data.items() if k.startswith("pin_")}
    if kind == "shard":
        part = sequence.shard_longform_batch({k: v.numpy() for k, v in data.items()}, mesh,
                                             halo=3)
        return {"mels": part["mels"], "txt_tokens": part["txt_tokens"],
                "n_frames": np.array(part["n_frames"])}
    if kind == "groups":  # PR 12's data helpers on the mesh's data group
        x = torch.tensor([float(dp.rank() + 1)])
        return {"sum": dp.all_reduce_sum(x, group=mesh.data_group).numpy(),
                "rows": dp.all_gather_rows(x[None], group=mesh.data_group).numpy(),
                "draw": dp.draw_rows(lambda s: torch.arange(float(s[0])), (2,),
                                     group=mesh.data_group).numpy()}
    if kind == "synthesize":
        svs = synthesizer(case)
        out = svs.synthesize({k: v.numpy() for k, v in data.items()},
                             generator=torch.Generator().manual_seed(case["seed"]))
        return {k: v.numpy() for k, v in out.items()}
    if kind == "infer":
        task = DiffSingerMIDITask(hp, case["vocab"], device="cpu")
        task.load_state(load_npz(case["params"]))
        batch = sequence.shard_longform_batch(
            {k: v for k, v in data.items() if not k.startswith("pin_")}, mesh, halo=None)
        with contextlib.ExitStack() as stack:
            if case.get("halo0"):
                stack.enter_context(halo_zero())
            out = task.infer_step(batch, **pins)
        assert out["mel_out"].shape[1] == batch["n_frames"] // mesh.size
        return out["mel_out"].numpy()
    n_rows = data["mel"].shape[0] // mesh.shape["data"]
    mine = lambda x: sequence.core_of(dp.local_rows(x, n_rows, group=mesh.data_group),  # noqa
                                      mesh)
    mel = mine(data["mel"])
    if kind == "pe":
        pe = PitchExtractor(hp)
        load_flax_params(pe, load_npz(case["params"]))
        return pe.eval()(mel, seq=mesh)["f0_denorm_pred"].numpy()
    if kind == "vocoder":
        gen = HifiGanGenerator(hp)
        load_flax_params(gen, load_npz(case["params"]))
        f0 = mine(data["f0"])
        # split on the frames, and whole on the gathered ones (a PWG's or a
        # multiband generator's way under seq)
        return {"split": gen.eval()(mel, f0, seq=mesh, **pins).numpy(),
                "whole": HifiGAN(hp, model=gen, device="cpu").generate_whole(
                    mel, f0, None, mesh, **pins).numpy()}
    raise ValueError(kind)


def pipe_case(case, mesh):
    hp = load_hparams_json(case["hp"])
    data = _np(case["inputs"])
    n_rows = data["spec"].shape[0] // mesh.shape["data"]
    spec, cond, t = (dp.local_rows(data[k], n_rows, group=mesh.data_group)
                     for k in ("spec", "cond", "t"))
    stage = pipeline.pipelined_denoiser(hp, mesh, case["n_micro"])
    pipeline.load_stage_params(stage, case["params"])
    cond_proj = stage.cond_projections(cond)
    if case["kind"] == "denoiser":
        return stage(spec, t, cond_proj).numpy()
    # a PLMS loop through the pipeline: the sampler with the stage as its denoiser
    model = GaussianDiffusion(hp, 8, spec.shape[-1])
    model.denoise_fn = stage
    out = model.plms_sample_loop(spec, cond_proj, int(hp["K_step"]), int(hp["pndm_speedup"]),
                                 stage.stack_weights())
    return model.denorm_spec(out).numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("spec")
    ap.add_argument("--init", required=True)
    args = ap.parse_args()
    with open(args.spec) as f:
        spec = json.load(f)
    dp.init_data_parallel("cpu", "gloo", args.init)
    try:
        axis, n, n_data = spec["mesh"]
        mesh = (sequence.make_seq_mesh if axis == "seq" else pipeline.make_pipe_mesh)(n, n_data)
        run = seq_case if axis == "seq" else pipe_case
        out = {"layout": np.array([mesh.data_index, mesh.index, dp.rank()])}
        with torch.no_grad(), mesh:
            for case in spec["cases"]:
                got = run(case, mesh)
                if isinstance(got, dict):
                    out.update({f"{case['name']}_{k}": v for k, v in got.items()})
                else:
                    out[case["name"]] = got
        np.savez(os.path.join(spec["out"], f"rank{dp.rank()}.npz"), **out)
    finally:
        dp.shutdown()


if __name__ == "__main__":
    main()
