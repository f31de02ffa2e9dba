"""Data parallelism of the port: the mesh's `data` axis as one process per
card (counterpart of `bisinger_tpu/parallel/mesh.py:1-86`; the `model`
axis, tensor parallelism, is `parallel/tensor.py`).

JAX trains data-parallel by SPMD: one program over the global batch, which
is sharded over the mesh's `data` axis, and XLA inserts the collectives.
The port runs one process a rank (launched by `torchrun`, or spawned over
gloo), each fed its rows of one global batch, and makes each rank's step
that program's share by hand:

  - every reduction over the batch divides a local sum by the global count
    (`global_count`, `global_mean`), so the ranks' losses are partial sums
    of JAX's global ones and their gradients sum to JAX's
    (`GradientReducer`: a sum, where DistributedDataParallel averages);
  - what the model computes across the batch sees the global batch: the
    Prenet's train-mode BatchNorm statistics (`all_reduce_sum` of the sums
    of x and x^2) and the ESM's attention over the batch axis
    (`all_gather_rows` of its keys and values), both differentiable;
  - the random draws at the batch's shape (dropout masks, the diffusion
    stage's t and noise) are drawn at the global shape from the generator
    every rank seeds alike, and each rank keeps its rows (`draw_rows`), so
    N ranks draw what one process draws on the whole batch.

The process group is torch.distributed's default group, formed by
`init_data_parallel` from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for CUDA devices (with gloo
beside it for host tensors), gloo for the CPU or when asked for (two ranks
sharing one card). Outside a group every helper is the one-process
identity. `all_reduce_sum`, `all_gather_rows`, `draw_rows`, `local_rows`
and `broadcast_` also take a subgroup (`group=`): the `data` group or the
axis group of a ('data', 'seq'), ('data', 'pipe') or ('data', 'model') mesh
(`parallel/groups.py`, which adds the point-to-point exchanges). Without
one, the helpers of the batch (`all_reduce_sum`, `all_gather_rows`,
`draw_rows`, `local_rows`, `global_count`, `global_mean`, `reduce_values`,
`GradientReducer`, and `data_size`) take the default data group,
`set_data_group`'s: the whole world, unless the trainer runs on a
('data', 'model') mesh (`mesh_shape.model > 1`, `groups.training_mesh`).
There, as in JAX's trainer, the state is replicated and the batch sharded
over `data` only: the ranks that differ only in their model index take the
same step on the same rows, and these helpers run over the data group of
the rank's model index. `broadcast_`, `barrier`, `any_rank` and
`check_identical` stay on the world. The `seq` and `pipe` axes are
`parallel/sequence.py`'s and `parallel/pipeline.py`'s.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import socket
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


def active() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if active() else 0


def is_main() -> bool:
    return rank() == 0


_DATA_GROUP = [None]  # the batch's group: None is the world


def set_data_group(group) -> None:
    """The group the batch's helpers default to (None: the world)."""
    _DATA_GROUP[0] = group


@contextlib.contextmanager
def using_data_group(group):
    """`set_data_group(group)` for the block, the earlier group after it."""
    prev = _DATA_GROUP[0]
    _DATA_GROUP[0] = group
    try:
        yield
    finally:
        _DATA_GROUP[0] = prev


def data_group(group=None):
    """`group`, else the default data group (None: the world)."""
    return _DATA_GROUP[0] if group is None else group


def data_size() -> int:
    """The ranks of the default data group: the global batch's shards."""
    return world_size(data_group())


def data_rank() -> int:
    """This rank's index in the default data group: its shard of the batch."""
    return rank(data_group())


def launched() -> bool:
    """Whether the process was started as a rank (torchrun's environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def data_axis_size(mesh_shape: Optional[Dict], n_ranks: int) -> int:
    """The `data` axis of `mesh_shape` as JAX's `make_mesh` reads it: -1 is
    every rank over the `model` axis (n_ranks // model); data x model must
    equal the number of ranks."""
    mesh_shape = dict(mesh_shape or {})
    model = int(mesh_shape.get("model", 1))
    data = int(mesh_shape.get("data", -1))
    if model < 1 or data < 1 and data != -1:
        raise ValueError(f"mesh_shape {mesh_shape}: the axes are positive (data may be -1)")
    if data == -1:
        if n_ranks % model:
            raise ValueError(f"mesh_shape.model={model} does not divide the run's {n_ranks} "
                             f"rank(s): launch a multiple of {model} ranks")
        return n_ranks // model
    if data * model != n_ranks:
        raise ValueError(f"mesh_shape.data={data} x model={model} but the run has {n_ranks} "
                         f"rank(s): set data to -1, or launch {data * model} ranks")
    return data


def init_data_parallel(device=None, backend: Optional[str] = None,
                       init_method: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: `device` when named (a bare "cuda" is
    cuda:LOCAL_RANK), else cuda:LOCAL_RANK. The backend is NCCL for a CUDA
    device, gloo for the CPU, unless `backend` names one; gloo may put
    several ranks on one card, NCCL raises. A group that fails to form
    raises: the run never goes on as one process. A second call in a
    process that is already a rank checks the group and returns the device."""
    world = int(os.environ["WORLD_SIZE"])
    rank_ = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass --device cpu to run the ranks on "
                               "the CPU over gloo")
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device found")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices, not {dev}; use gloo")
    if active():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank_):
            raise RuntimeError(f"this process is rank {dist.get_rank()} of "
                               f"{dist.get_world_size()}, not {rank_} of {world}")
        return dev
    # NCCL for the card's tensors; host tensors (counters, checksums, the
    # preemption flag) go over gloo in either case
    dist.init_process_group(backend="cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo",
                            init_method=init_method or "env://", world_size=world, rank=rank_)
    if backend == "nccl":
        _refuse_shared_devices(dev)
    return dev


def _refuse_shared_devices(dev: torch.device) -> None:
    """NCCL does not run two ranks on one device: raise, naming it, before
    the first NCCL collective (which would hang or fail inside NCCL)."""
    props = torch.cuda.get_device_properties(dev)
    ident = f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"
    mine = int.from_bytes(hashlib.sha256(ident.encode()).digest()[:7], "little")
    ids = gather_ints([mine])
    if ids.count(mine) > 1:
        others = [r for r, v in enumerate(ids) if v == mine and r != rank()]
        shutdown()
        raise RuntimeError(f"NCCL: ranks {sorted(others + [rank()])} share the device {dev} "
                           f"({torch.cuda.get_device_name(dev)}); NCCL needs one device a rank "
                           "(use --dist_backend gloo to share a card)")


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


# ---- collectives (each the identity outside a group) --------------------
def barrier() -> None:
    """Every rank waits here for the others (a host all-reduce, so it takes
    the same path under NCCL and gloo)."""
    if active():
        dist.all_reduce(torch.zeros(1))


class _AllReduceSum(torch.autograd.Function):
    """x summed over the ranks; the gradient of every rank's input is the
    sum of the ranks' output gradients, since each rank's output is the
    same function of every input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks (of `group`, default the data group),
    differentiable."""
    if not active():
        return x
    group = data_group(group)
    if x.requires_grad:
        return _AllReduceSum.apply(x, group)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def all_gather_rows(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' x [B, ...] stacked in rank order into [B x N, ...] (along
    `dim`, default the rows), differentiable: each rank writes its part
    into zeros and the ranks sum (adding zeros is exact), which gloo also
    runs on CUDA tensors. `group` defaults to the data group."""
    group = data_group(group)
    n = world_size(group)
    if n == 1:
        return x
    dim %= x.ndim
    b, r = x.shape[dim], rank(group)
    zeros = lambda k: x.new_zeros((*x.shape[:dim], k * b, *x.shape[dim + 1:]))  # noqa: E731
    return all_reduce_sum(torch.cat([zeros(r), x, zeros(n - 1 - r)], dim), group)


def gather_ints(values: Sequence[int]) -> List[int]:
    """Each rank's ints, in rank order (on the host)."""
    n, r = world_size(), rank()
    buf = torch.zeros((n, len(values)), dtype=torch.int64)
    buf[r] = torch.as_tensor(list(values), dtype=torch.int64)
    if active():
        dist.all_reduce(buf)
    return buf.reshape(-1).tolist()


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank (every rank must call this)."""
    if not active():
        return flag
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count of this rank's rows (a mask's sum) summed over the ranks, as
    data: no gradient passes through it."""
    return all_reduce_sum(count.detach())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the global batch, as this rank's share: the local
    sum over every data rank's element count (the ranks' shapes are equal)."""
    return x.sum() / (x.numel() * data_size())


def reduce_values(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalars summed over the data ranks in one all-reduce (the losses'
    partial sums -> the global losses), keys in order."""
    if not active() or not values:
        return values
    flat = torch.stack(list(values.values()))
    dist.all_reduce(flat, group=data_group())
    return dict(zip(values, flat.unbind()))


# ---- the global batch's draws and rows ------------------------------------
def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
              group=None) -> torch.Tensor:
    """`draw(global shape)` with this rank's rows kept: the global batch's
    draw, N x shape[0] rows (N the ranks of `group`, default the data
    group), from the generator every rank seeds alike."""
    group = data_group(group)
    n = world_size(group)
    if n == 1:
        return draw(tuple(shape))
    b, r = shape[0], rank(group)
    return draw((b * n, *shape[1:]))[r * b:(r + 1) * b]


def local_rows(x: torch.Tensor, n_local: int, group=None) -> torch.Tensor:
    """This rank's rows of `x`, given at the global batch's shape (over the
    ranks of `group`, default the data group)."""
    group = data_group(group)
    n = world_size(group)
    if x.shape[0] != n_local * n:
        raise ValueError(f"expected the global batch's {n_local * n} rows ({n} rank(s) of "
                         f"{n_local}), got {x.shape[0]}")
    r = rank(group)
    return x[r * n_local:(r + 1) * n_local]


# ---- state agreement -------------------------------------------------------
def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite every rank's tensors (of `group`, default all) with global
    rank `src`'s, in place."""
    if not active():
        return
    for t in tensors:
        dist.broadcast(t.data, src, group=group)


def digest(tensors: Iterable[torch.Tensor]) -> str:
    """sha256 of the tensors' bytes, in order: equal only when bit-identical."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def check_identical(tensors: Iterable[torch.Tensor], what: str) -> str:
    """The digest of `tensors`, after checking that every rank holds the
    same; raises naming the ranks that differ from rank 0."""
    d = digest(tensors)
    if active():
        ids = gather_ints([int(d[:15], 16)])
        bad = [r for r, v in enumerate(ids) if v != ids[0]]
        if bad:
            raise RuntimeError(f"{what}: ranks {bad} differ from rank 0 ({d[:12]} on rank "
                               f"{rank()})")
    return d


BUCKET_MB = 25  # DistributedDataParallel's default bucket


class GradientReducer:
    """Sums the parameters' gradients over the data ranks after the backward
    pass, as one all-reduce of a flat buffer (fp32, the parameters' dtype)
    per bucket of about BUCKET_MB MiB; the gradients become views of the
    buckets. A parameter that got no gradient adds zeros (the optimizer
    counts it as a zero gradient either way). Each rank's losses carry the
    global batch's denominators, so the sum is JAX's global-batch gradient.
    Outside a group it does nothing. `take_ms` reads the time spent in the
    all-reduces since the last read."""

    def __init__(self, params: Dict[str, torch.nn.Parameter]):
        self.params = list(params.values())
        limit = BUCKET_MB * 2 ** 20 // 4
        self.buckets: List[List[torch.nn.Parameter]] = [[]]
        size = 0
        for p in self.params:
            if self.buckets[-1] and size + p.numel() > limit:
                self.buckets.append([])
                size = 0
            self.buckets[-1].append(p)
            size += p.numel()
        self._spans: list = []  # (start, end) events on the card, or host seconds

    def __call__(self) -> None:
        if not active():
            return
        cuda = self.params[0].is_cuda
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for bucket in self.buckets:
            flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                              .reshape(-1) for p in bucket])
            dist.all_reduce(flat, group=data_group())
            for p, g in zip(bucket, flat.split([p.numel() for p in bucket])):
                p.grad = g.view_as(p)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._spans.append((start, end))
        else:
            self._spans.append(time.perf_counter() - t0)

    def take_ms(self) -> float:
        """Milliseconds spent in the all-reduces since the last call."""
        spans, self._spans = self._spans, []
        if spans and isinstance(spans[-1], tuple):
            spans[-1][1].synchronize()
        return sum(s[0].elapsed_time(s[1]) if isinstance(s, tuple) else 1e3 * s
                   for s in spans)
