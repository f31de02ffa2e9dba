"""One rank of the port's tensor-parallel runs in
tests/test_torch_tensor_parallel.py, on the CPU over gloo. It imports torch,
numpy and the port only (no JAX), reads its rank from RANK and WORLD_SIZE
(4 ranks) and joins the group through the file named by `--init`:

    python tests/torch_tp_worker.py SPEC.json --init file:///...

SPEC's cases:
  - "diffnet", "vocoder", "pe": the module's TP view (`tensor.shard_for_tp`)
    on a ('data' 2, 'model' 2) mesh, each model group on the same inputs;
    every rank writes its output and the calls of the K1 and K2 wrappers;
  - "synthesize": `SVSInferTorch.synthesize` under `make_mesh(1, 2)` (ranks
    0 and 1; 2 and 3 are outside that mesh);
  - "train": one train step of each listed task on a {data: 2, model: 1}
    mesh (ranks 0 and 1, the data group of two) and then on {data: 2,
    model: 2} (all four), the batch's helpers on the mesh's data group as
    the trainer sets it (`groups.training_mesh`); each rank writes the
    parameters and buffers after the step and the digest of its whole state,
    and the shards of the batch a Trainer under mesh_shape {data: -1,
    model: 2} gives it.
This rank's results go to <out>/rank<R>.npz.
"""

import argparse
import json
import os

import numpy as np
import torch

from bisinger_tpu_torch.config import load_hparams_json
from bisinger_tpu_torch.data.dataset import batch_to_device
from bisinger_tpu_torch.models import diffnet, hifigan
from bisinger_tpu_torch.models.diffnet import DiffNet
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.parallel import groups, tensor
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.training.tasks import task_class
from bisinger_tpu_torch.training.trainer import Trainer
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params, load_npz

from torch_sp_worker import synthesizer

torch.set_num_threads(1)
CALLS = {"K1": 0, "K2": 0}  # calls of the kernels' wrappers (their plain versions here)


def _count(module, names, kernel):
    for name in names:
        real = getattr(module, name)

        def wrapped(*a, real=real, **k):
            CALLS[kernel] += 1
            return real(*a, **k)

        setattr(module, name, wrapped)


_count(diffnet, ("residual_stack", "residual_stack_bf16"), "K1")
_count(hifigan, ("mrf_stage", "mrf_stage_bf16"), "K2")


def _np(path):
    return {k: torch.as_tensor(v) for k, v in np.load(path).items()}


def module_case(case, mesh):
    hp = load_hparams_json(case["hp"])
    cls = {"diffnet": DiffNet, "vocoder": HifiGanGenerator, "pe": PitchExtractor}[case["kind"]]
    module = cls(hp)
    load_flax_params(module, load_npz(case["params"]))
    view = tensor.shard_for_tp(module.eval(), mesh)
    inp = _np(case["inputs"])
    if case["kind"] == "diffnet":
        return view(inp["spec"], inp["t"], view.cond_projections(inp["cond"]),
                    view.stack_weights()).numpy()
    if case["kind"] == "vocoder":
        return view(inp["mel"], inp["f0"], phase=inp["pin_phase"], noise=inp["pin_noise"]).numpy()
    return view(inp["mel"])["f0_denorm_pred"].numpy()


def train_steps(case):
    """One step of each task on the {data 2, model 1} and {data 2, model 2}
    meshes: {"<task>_<data>x<model>_param/<key>": value, ..._digest}."""
    out = {}
    data = dict(np.load(case["batch"]))
    for data_n, model_n in ((2, 1), (2, 2)):
        if model_n > 1:  # the trainer's mesh, from mesh_shape as the Trainer reads it
            groups.training_mesh({"data": data_n, "model": model_n})
        else:  # ranks 0 and 1 alone: a data-parallel run of two
            mesh = tensor.make_mesh(data_n, model_n)
            if not mesh.member:
                continue
            dp.set_data_group(mesh.data_group)
        try:
            for name in case["tasks"]:
                hp = load_hparams_json(case["hp"][name])
                cls = task_class(name)
                task = cls(hp, device="cpu") if name == "PitchExtractionTask" else \
                    cls(hp, case["vocab"], device="cpu")
                task.load_state(load_npz(case["params"][name]))
                n = data["mels"].shape[0] // dp.data_size()
                r = dp.data_rank()
                rows = {k: v[r * n:(r + 1) * n] for k, v in data.items()}
                gen = torch.Generator().manual_seed(case["seed"])
                task.train_step(batch_to_device(rows, "cpu"), gen)
                opt = task.opt.state_dict()
                state = (list(task.model.parameters()) + list(task.model.buffers())
                         + [v for v in opt.values() if torch.is_tensor(v)]
                         + [gen.get_state()])
                tag = f"{name}_{data_n}x{model_n}"
                out.update({f"{tag}_param/{k}": v
                            for k, v in export_flax_params(task.model).items()})
                out[f"{tag}_digest"] = np.array(dp.digest(state))
        finally:
            dp.set_data_group(None)
    # the Trainer on the same mesh_shape: its loaders' shards
    hp = load_hparams_json(case["hp"][case["tasks"][0]])
    task = task_class(case["tasks"][0])(hp, case["vocab"], device="cpu")
    tr = Trainer(task, dict(hp, mesh_shape={"data": -1, "model": 2}),
                 work_dir=os.path.join(case["work_dir"], f"rank{dp.rank()}"))
    out["trainer_shards"] = np.array([tr.n_data, tr.data_index, tr.mesh.shape["data"],
                                      tr.mesh.shape["model"]])
    dp.set_data_group(None)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("spec")
    ap.add_argument("--init", required=True)
    args = ap.parse_args()
    with open(args.spec) as f:
        spec = json.load(f)
    dp.init_data_parallel("cpu", "gloo", args.init)
    out = {}
    try:
        with torch.no_grad(), tensor.make_mesh(num_data=2, num_model=2) as mesh:
            out["layout"] = np.array([mesh.data_index, mesh.index, dp.rank()])
            for case in spec["cases"]:
                if case["kind"] in ("diffnet", "vocoder", "pe"):
                    CALLS.update(K1=0, K2=0)
                    out[case["name"]] = module_case(case, mesh)
                    out[f"{case['name']}_kernel_calls"] = np.array([CALLS["K1"], CALLS["K2"]])
        for case in spec["cases"]:
            if case["kind"] == "synthesize":
                m = tensor.make_mesh(num_data=1, num_model=2)
                if m.member:
                    svs = synthesizer(case)
                    with torch.no_grad(), m:
                        res = svs.synthesize({k: v for k, v in np.load(case["inputs"]).items()},
                                             generator=torch.Generator().manual_seed(case["seed"]))
                    out.update({f"synthesize_{k}": v.numpy() for k, v in res.items()})
            elif case["kind"] == "train":
                out.update(train_steps(case))
        np.savez(os.path.join(spec["out"], f"rank{dp.rank()}.npz"), **out)
    finally:
        dp.shutdown()


if __name__ == "__main__":
    main()
