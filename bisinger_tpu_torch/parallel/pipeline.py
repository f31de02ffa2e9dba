"""Pipeline parallelism of the DiffNet over the `pipe` ranks of a ('data',
'pipe') mesh (counterpart of `bisinger_tpu/parallel/pipeline.py`).

The L residual layers are split into S contiguous stages, one a rank; a
rank builds and loads its stage's layers only (`PipelinedDiffNet`,
`load_stage_params`), which is the memory this mode saves. The layers a
stage holds must be a multiple of `dilation_cycle_length`, so every stage
runs the same dilations (`split_stages`' assertion; S in {1, 5} at the
flagship's 20 layers, cycle 4).

A denoiser call splits the batch into M micro-batches and runs JAX's
GPipe schedule of M + S - 1 ticks: stage s takes micro-batch i at tick
s + i, runs its layers in one K1 launch in the write-last mode (the skip
sum and the last layer's x), adds its fp32 skip to the one it received,
and hands (x, skip) to stage s + 1 (point-to-point: through host memory
under gloo, card to card under NCCL). The last stage's skip sums go to
every `pipe` rank (a broadcast, JAX's psum of the last stage's buffer),
and the prologue (input projection, step MLP) and the final projections
run on every rank, as in JAX. The module has the DiffNet's interface
(`cond_projections`, `stack_weights`, `forward(x, t, cond_proj, stack)`),
so the samplers run through it unchanged (`GaussianDiffusion.denoise_fn`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bisinger_tpu_torch.models.diffnet import DiffNet
from bisinger_tpu_torch.parallel import groups
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.parallel.groups import ProcessMesh, make_pipe_mesh  # noqa: F401
from bisinger_tpu_torch.weights import load_flax_params


def _res_keys(params: Dict) -> List[str]:
    return sorted((k for k in params if k.startswith("res_")), key=lambda k: int(k[4:]))


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(a) for a in leaves])


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return _stack(trees)


def _blocks_per_stage(n_layers: int, n_stages: int, cycle: int) -> int:
    """JAX's assertions (AssertionError), raised also under `python -O`."""
    if n_layers % n_stages:
        raise AssertionError((n_layers, n_stages))
    bps = n_layers // n_stages
    if bps % cycle:
        raise AssertionError(
            f"blocks_per_stage={bps} must be a multiple of dilation_cycle_length={cycle} so "
            f"all stages share one static dilation pattern")
    return bps


def split_stages(diffnet_params: Dict, n_stages: int, cycle: int) -> Tuple[Dict, List[Dict]]:
    """A DiffNet's flax-named tree -> (shared, stage_blocks): shared the
    input, skip and output projections and the step MLP; stage_blocks a
    list over the position j within a stage of trees whose leaves are
    stacked [S, ...] over the stages (so position j's dilation 2^(j %
    cycle) is one for every stage). Asserts as JAX does."""
    res_keys = _res_keys(diffnet_params)
    bps = _blocks_per_stage(len(res_keys), n_stages, cycle)
    shared = {k: v for k, v in diffnet_params.items() if not k.startswith("res_")}
    stage_blocks = [_tree_stack([diffnet_params[res_keys[s * bps + j]]
                                 for s in range(n_stages)]) for j in range(bps)]
    return shared, stage_blocks


def _conv1x1(x, p):
    w, b = (torch.as_tensor(p[k]).to(x.dtype) for k in ("kernel", "bias"))
    return x @ w[0] + b


def cond_projections_stacked(diffnet_params: Dict, cond: torch.Tensor, n_stages: int,
                             dtype=None) -> torch.Tensor:
    """[S, L / S, B, T, 2C] conditioner projections from the flax-named tree
    (step-invariant, once an utterance, as `DiffNet.cond_projections`;
    `dtype` bfloat16 as a compute_dtype=bfloat16 module)."""
    if dtype is not None:
        cond = cond.to(dtype)
    proj = torch.stack([_conv1x1(cond, diffnet_params[k]["conditioner_projection"])
                        for k in _res_keys(diffnet_params)])
    return proj.reshape((n_stages, proj.shape[0] // n_stages) + tuple(proj.shape[1:]))


def stage_layers(hp, n_stages: int, stage: int) -> range:
    """The residual layers of `stage` of `n_stages`, with `split_stages`'
    assertions."""
    bps = _blocks_per_stage(int(hp["residual_layers"]), n_stages,
                            int(hp["dilation_cycle_length"]))
    return range(stage * bps, (stage + 1) * bps)


class PipelinedDiffNet(DiffNet):
    """This rank's stage of the DiffNet over `mesh`'s `pipe` axis, run in
    `n_micro` micro-batches (`pipelined_denoiser`)."""

    def __init__(self, hp: dict, mesh: ProcessMesh, n_micro: int, in_dims: int = 80):
        mesh.check_member()
        super().__init__(hp, in_dims, layers=stage_layers(hp, mesh.size, mesh.index))
        self.mesh, self.n_micro = mesh, int(n_micro)

    def forward(self, spec, diffusion_step, cond_proj=None, stack=None, cond=None):
        """spec [B, T, M], diffusion_step [B] and this stage's cond_proj [L / S,
        B, T, 2C] -> predicted noise [B, T, M], the same on every `pipe`
        rank."""
        if cond is not None:
            raise NotImplementedError("the pipelined DiffNet runs inference only")
        stack = stack if stack is not None else self.stack_weights()
        x, step_proj = self.prologue(spec, diffusion_step, stack)
        m, S, s = self.mesh, self.mesh.size, self.mesh.index
        b, t, c = x.shape
        if b % self.n_micro:
            raise ValueError(f"{b} rows do not split into {self.n_micro} micro-batches")
        mb = b // self.n_micro
        run = self.stack_fn()
        skips, pending = [], []
        for i in range(self.n_micro):
            rows = slice(i * mb, (i + 1) * mb)
            if s == 0:
                h, received = x[rows].contiguous(), None
            else:
                h = groups.recv(x[rows], m, s - 1)
                received = groups.recv(x.new_empty((mb, t, c), dtype=torch.float32), m, s - 1)
            skip, h = run(h, cond_proj[:, rows].contiguous(), step_proj[:, rows].contiguous(),
                          *stack[2:6], self.dilations, write_last=True)
            if received is not None:
                skip = received + skip
            if s + 1 < S:
                pending += [groups.send(h, m, s + 1), groups.send(skip, m, s + 1)]
            else:
                skips.append(skip)
        for req, _ in pending:
            req.wait()
        total = torch.cat(skips) if s + 1 == S else x.new_empty((b, t, c), dtype=torch.float32)
        if S > 1:
            dp.broadcast_([total], m.ranks[S - 1], group=m.group)
        return self.epilogue(total, stack[6])


def pipelined_denoiser(hp: dict, mesh: ProcessMesh, n_micro: int, in_dims: int = 80
                       ) -> PipelinedDiffNet:
    """This rank's stage of the DiffNet, with the samplers' denoiser
    signature (`denoise_fn(x, t, cond_proj, stack)`); load its weights with
    `load_stage_params`."""
    return PipelinedDiffNet(hp, mesh, n_micro, in_dims).eval()


def load_stage_params(stage: DiffNet, source, prefix: str = "denoise_fn/") -> None:
    """Load a stage's share of a DiffNet's flat flax weights under `prefix`:
    from an npz path, only the shared projections and this stage's
    layers are read; from a dict, keys under `prefix` of another stage's
    layers are refused (KeyError), as are missing ones. Keys outside
    `prefix` (the conditioner's) are not the DiffNet's and are skipped."""
    mine = set(stage.layer_ids)

    def layer_of(key):
        head = key[len(prefix):].split("/", 1)[0]
        return int(head[4:]) if head.startswith("res_") else None

    if isinstance(source, str):
        with np.load(source, allow_pickle=False) as z:
            flat = {k[len(prefix):]: z[k] for k in z.files
                    if k.startswith(prefix) and layer_of(k) in mine | {None}}
    else:
        flat = {}
        for k, v in source.items():
            if not k.startswith(prefix):
                continue
            layer = layer_of(k)
            if layer is not None and layer not in mine:
                raise KeyError(f"{k!r} is layer {layer}, not of this stage's layers "
                               f"{sorted(mine)}")
            flat[k[len(prefix):]] = v
    load_flax_params(stage, flat)
