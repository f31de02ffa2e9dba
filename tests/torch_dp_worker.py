"""One rank of the port's data-parallel runs in tests/test_torch_data_parallel.py,
on the CPU over gloo. It imports torch and the port only (no JAX), reads its
rank from torchrun's variables (RANK, WORLD_SIZE) and joins the group through
the file named by `--init`:

    python tests/torch_dp_worker.py step SPEC.json --init file:///...
        one train step of each task that SPEC lists, on this rank's rows of
        the global batch; writes <out>.rank<R>.npz per task: the losses, the
        gradients and parameters after the step under their flax keys, and
        the digest of the task's whole state;
    python tests/torch_dp_worker.py fit OUT.json -- RUN_ARGS...
        run's trainer (`run.trainer_from_args`) fit to --max_updates; writes
        the train and validation logs of this rank to OUT.json.
"""

import argparse
import copy
import json
import sys

import numpy as np
import torch

from bisinger_tpu_torch import run
from bisinger_tpu_torch.config import load_hparams_json
from bisinger_tpu_torch.data.dataset import batch_to_device
from bisinger_tpu_torch.models import common
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.training.tasks import task_class
from bisinger_tpu_torch.weights import export_flax_params, load_npz

torch.set_num_threads(1)


def flat_grads(model):
    """The parameters' .grad under their flax keys and layouts."""
    g = copy.deepcopy(model)
    for p, q in zip(model.parameters(), g.parameters()):
        q.data = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
    return {k: v for k, v in export_flax_params(g).items()
            if k.rsplit("/", 1)[-1] not in ("mean", "var")}


def pin_pe_dropout(model, masks):
    """The PitchExtractor's five dropout masks, given at this rank's rows."""
    layers = [getattr(model.pitch_predictor, f"conv_{i}").dropout for i in range(5)]
    for d, m in zip(layers, masks):
        d.forward = lambda x, m=torch.as_tensor(m), d=d: torch.where(
            m, common.div(x, 1.0 - d.rate), torch.zeros((), dtype=x.dtype))


def step(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    r = dp.rank()
    for case in spec["cases"]:
        hp = load_hparams_json(case["hp"])
        cls = task_class(case["task"])
        task = (cls(hp, device="cpu") if case["task"] == "PitchExtractionTask"
                else cls(hp, spec["vocab"], device="cpu"))
        task.load_state(load_npz(case["params"]))
        data = dict(np.load(case["batch"]))
        n = data["mels"].shape[0] // dp.world_size()
        rows = {k: v[r * n:(r + 1) * n] for k, v in data.items()}
        pins = {k: torch.as_tensor(np.load(case["pins"])[k]) for k in case.get("pin_keys", [])}
        if "masks" in case:
            pin_pe_dropout(task.model, np.load(case["masks"])["masks"][:, r * n:(r + 1) * n])
        out = task.train_step(batch_to_device(rows, "cpu"), **pins)
        opt = task.opt.state_dict()
        state = (list(task.model.parameters()) + list(task.model.buffers())
                 + [v for v in opt.values() if torch.is_tensor(v)])
        result = {f"loss/{k}": v.numpy() for k, v in out.items()}
        result.update({f"grad/{k}": v for k, v in flat_grads(task.model).items()})
        result.update({f"param/{k}": v for k, v in export_flax_params(task.model).items()})
        result["digest"] = np.array(dp.check_identical(state, case["task"]))
        np.savez(f"{case['out']}.rank{r}.npz", **result)


def fit(out_path, run_args):
    args = run.parse_args(run_args)
    tr = run.trainer_from_args(args)
    tr.fit(max_updates=args.max_updates or None)
    with open(f"{out_path}.rank{tr.rank}.json", "w") as f:
        json.dump({"train": [(s, m) for s, _, m in tr.train_log], "val": tr.val_log}, f)


def main():
    own, run_args = (sys.argv[1:sys.argv.index("--")], sys.argv[sys.argv.index("--") + 1:]) \
        if "--" in sys.argv else (sys.argv[1:], [])
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("step", "fit"))
    parser.add_argument("path")
    parser.add_argument("--init", default=None)
    args = parser.parse_args(own)
    try:
        if args.mode == "step":
            dp.init_data_parallel("cpu", "gloo", args.init)
            step(args.path)
        else:
            fit(args.path, run_args)
    finally:
        dp.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
