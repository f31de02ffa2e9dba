"""Two-axis meshes of ranks: ('data', 'seq'), ('data', 'pipe') and
('data', 'model') (counterparts of `make_seq_mesh`,
`bisinger_tpu/parallel/sequence.py:49-65`, `make_pipe_mesh`,
`bisinger_tpu/parallel/pipeline.py:49-57`, and `make_mesh`,
`bisinger_tpu/parallel/mesh.py:31-44`).

JAX lays devices out on a `Mesh`; the port lays the ranks of the default
process group (`parallel/mesh.py`: gloo ranks on the CPU or sharing one
card, NCCL ranks one card each) out row-major, rank = d * n + i for data
index d and axis index i, as JAX's `create_device_mesh` orders a CPU
device list. Every rank builds every subgroup, in the same order: the
axis groups (one per data index), then the data groups (one per axis
index). Ranks past num_data * n are in no group of the mesh, as JAX leaves
the devices past its product out.

A mesh is also a context (`with mesh:`), as JAX's: an entry point
(`SVSInferTorch.synthesize`, `DiffSingerMIDITask.infer_step`) finds the
entered mesh of an axis with `ambient(axis)` and passes it down. The
trainer's ('data', 'model') mesh (`training_mesh`) is not entered: it sets
the default data group of `parallel/mesh.py`'s batch helpers.

The collectives over a mesh's subgroups are `parallel/mesh.py`'s (each
takes `group=`: `m.group`, `m.data_group`), which gloo also runs on CUDA
tensors. The point-to-point exchanges are here: under gloo a CUDA tensor
goes through host memory (gloo's point-to-point operations take host
tensors); under NCCL it stays on its card.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from bisinger_tpu_torch.parallel import mesh as dp

_AMBIENT: List["ProcessMesh"] = []


class ProcessMesh:
    """This rank's place in a ('data', axis) mesh: `shape`, `data_index`,
    `index` (along the axis), `group` (its axis group), `data_group`,
    `ranks` (the global ranks of its axis group, in axis order)."""

    def __init__(self, axis: str, num_data: int, num: int):
        self.axis = axis
        self.shape = {"data": num_data, axis: num}
        self.size = num
        world = dp.world_size()
        wanted = num_data * num
        if num_data < 1 or num < 1 or wanted > world:
            raise ValueError(f"Number of ranks {world} must equal the product of mesh_shape "
                             f"({num_data}, {num}) (or exceed it; the ranks past it stay out)")
        axis_ranks = [[d * num + i for i in range(num)] for d in range(num_data)]
        data_ranks = [[d * num + i for d in range(num_data)] for i in range(num)]
        if dp.active():
            axis_groups = [dist.new_group(r) for r in axis_ranks]
            data_groups = [dist.new_group(r) for r in data_ranks]
        else:
            axis_groups, data_groups = [None], [None]
        me = dp.rank()
        self.member = me < wanted
        self.data_index, self.index = divmod(me, num) if self.member else (None, None)
        if self.member:
            self.group = axis_groups[self.data_index]
            self.data_group = data_groups[self.index]
            self.ranks = axis_ranks[self.data_index]

    def check_member(self):
        if not self.member:
            raise RuntimeError(f"rank {dp.rank()} is outside the {self.shape} mesh")

    def __enter__(self):
        self.check_member()
        _AMBIENT.append(self)
        return self

    def __exit__(self, *exc):
        _AMBIENT.remove(self)
        return False

    def __repr__(self):
        return f"ProcessMesh({self.shape}, data {self.data_index}, {self.axis} {self.index})"


def make_seq_mesh(num_seq: int = -1, num_data: int = 1) -> ProcessMesh:
    """('data', 'seq') mesh; num_seq=-1 takes every remaining rank. 'data'
    splits the batch, 'seq' the mel frames of a long score."""
    if num_seq == -1:
        num_seq = dp.world_size() // num_data
    return ProcessMesh("seq", num_data, num_seq)


def make_pipe_mesh(num_pipe: int, num_data: int = 1) -> ProcessMesh:
    """('data', 'pipe') mesh: pipeline neighbours are adjacent ranks."""
    return ProcessMesh("pipe", num_data, num_pipe)


def make_mesh(num_data: int = -1, num_model: int = 1) -> ProcessMesh:
    """('data', 'model') mesh, JAX's signature and sizes: num_data=-1 takes
    every remaining rank (world // num_model). 'model' is the tensor-parallel
    axis (`parallel/tensor.py`)."""
    if num_data == -1:
        num_data = dp.world_size() // num_model
    return ProcessMesh("model", num_data, num_model)


def training_mesh(mesh_shape) -> Optional[ProcessMesh]:
    """The trainer's mesh, as JAX's trainer builds it from `mesh_shape`
    (`bisinger_tpu/training/trainer.py:95-98`): with model > 1 the
    ('data', 'model') mesh, whose data group (the ranks of this rank's model
    index) becomes `parallel/mesh.py`'s default data group, so that the
    batch is sharded over `data` only and the ranks of one data index take
    the same step; else None (the data group is the world). Raises unless
    data x model is the number of ranks."""
    shape = dict(mesh_shape or {})
    model = int(shape.get("model", 1))
    data = dp.data_axis_size(shape, dp.world_size())
    if model == 1:
        dp.set_data_group(None)
        return None
    m = make_mesh(data, model)
    dp.set_data_group(m.data_group)
    return m


def ambient(axis: str) -> Optional[ProcessMesh]:
    """The innermost mesh entered (`with mesh:`) that has `axis`, or None."""
    for m in reversed(_AMBIENT):
        if m.axis == axis:
            return m
    return None


# ---- the axis's running sums and point-to-point exchanges ---------------------
def _on_host(x: torch.Tensor, group) -> bool:
    """Whether x must go through host memory for `group`: a CUDA tensor
    under a backend without NCCL."""
    return x.is_cuda and "nccl" not in str(dist.get_backend(group)).lower()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as the point-to-point operations carry it: bf16 as its bits."""
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def exclusive_prefix(x: torch.Tensor, m: ProcessMesh) -> torch.Tensor:
    """The sum of x over the axis ranks before this one (zeros on the
    first), summed in axis order."""
    parts = dp.all_gather_rows(x[None], group=m.group)
    out = torch.zeros_like(x)
    for i in range(m.index):
        out = out + parts[i]
    return out


def exchange(sends: Dict[int, torch.Tensor], recvs: Dict[int, torch.Tensor],
             m: ProcessMesh) -> Dict[int, torch.Tensor]:
    """Point-to-point over the axis: `sends[i]` goes to axis rank i, and
    `recvs[i]` (a buffer of the shape axis rank i sends) is filled from it;
    returns the filled buffers on their own devices. Every send is matched
    by the receiving rank's buffer; all are posted at once and waited for."""
    ops, outs = [], {}
    for i, t in sorted(sends.items()):
        h = _on_host(t, m.group)
        ops.append(dist.P2POp(dist.isend, _wire((t.cpu() if h else t).contiguous()),
                              m.ranks[i], group=m.group))
    for i, buf in sorted(recvs.items()):
        outs[i] = torch.empty(buf.shape, dtype=buf.dtype,
                              device="cpu" if _on_host(buf, m.group) else buf.device)
        ops.append(dist.P2POp(dist.irecv, _wire(outs[i]), m.ranks[i], group=m.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {i: outs[i].to(recvs[i].device) for i in outs}


def send(x: torch.Tensor, m: ProcessMesh, dst_index: int):
    """Start sending x to axis rank `dst_index`; returns the request (wait
    on it before x's buffer is reused)."""
    t = _wire((x.cpu() if _on_host(x, m.group) else x).contiguous())
    return dist.isend(t, m.ranks[dst_index], group=m.group), t


def recv(like: torch.Tensor, m: ProcessMesh, src_index: int) -> torch.Tensor:
    """A tensor of `like`'s shape and dtype from axis rank `src_index`, on
    `like`'s device."""
    host = _on_host(like, m.group)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
    dist.recv(_wire(buf), m.ranks[src_index], group=m.group)
    return buf.to(like.device)

