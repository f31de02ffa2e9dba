"""Sequence parallelism: long-form synthesis with the mel frames split over
the `seq` ranks of a ('data', 'seq') mesh (counterpart of
`bisinger_tpu/parallel/sequence.py`).

JAX annotates the frame axis of the synth path's activations
(`constrain_time`, gated on `sequence_parallel_axis`) and lets GSPMD insert
the halo exchanges each convolution needs. The port does by hand what
that program does:

  - each `seq` rank owns an even split of the T frames, its core
    (`time_spec`; T must divide by the axis, as JAX's `device_put` needs);
  - a module whose output frame depends on its input's frames within a
    reach r (its receptive field, `halo_for`: the DiffNet's sum of
    dilations, the PE's and the vocoder's convolution stacks) runs on the
    core widened by r frames on each side (`window`), taken from the
    neighbours' cores (`halo_exchange`). The module pads its edges with
    zeros, which are wrong inside the sequence: the error moves inward by
    at most r frames, so the core is exact. Rank 0 has no left halo and the
    last rank no right one: the sequence's true ends keep their padding;
  - statistics over the whole time axis (the PE's GroupNorm) sum over
    the cores across the axis (`mesh.all_reduce_sum` on the axis group);
    running sums (the NSF phase, the PE's positions) start from the
    earlier ranks' core totals (`groups.exclusive_prefix`);
  - random draws are made at the global shape, and each rank keeps its
    rows and frames (`local_window`), so the ranks draw what one process
    draws.

The conditioner is token-level and its frame-level attention spans the
score: each rank runs it whole on its rows, and keeps its chunk of the
decoder input and of the fs2 mel (`models/diffusion.py`).

The entry points (`SVSInferTorch.synthesize` and `infer_batch`,
`DiffSingerMIDITask.infer_step`) find the mesh once (`context`):
`sequence_parallel_axis` names the axis (default "": off), and the mesh
must be entered (`with make_seq_mesh(...):`) on every rank, as JAX's
`with mesh:`; an axis named without an entered mesh raises. They pass it
down: the sampler, the PE and the vocoder take it as an argument
(`seq=`), and know nothing of the hyperparameter.
The ranks are processes of one group (`parallel/mesh.init_data_parallel`):
gloo on the CPU or sharing one card, NCCL over separate cards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bisinger_tpu_torch.parallel import groups
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.parallel.groups import ProcessMesh, make_seq_mesh  # noqa: F401

# the frame-level keys of a batch (`sequence.py:95`): split over `seq`
FRAME_KEYS = frozenset({"mels", "mel2ph", "f0", "uv", "pitch", "energy"})


def context(hp) -> Optional[ProcessMesh]:
    """The `seq` mesh an entry point runs under: the entered mesh of the
    axis `hp["sequence_parallel_axis"]` names, else None (the axis
    unset)."""
    axis = (hp or {}).get("sequence_parallel_axis", "") or ""
    if not axis:
        return None
    m = groups.ambient(axis)
    if m is None:
        raise RuntimeError(f"sequence_parallel_axis={axis!r}, but no ('data', {axis!r}) mesh "
                           "is entered: run under `with make_seq_mesh(...):` on every rank")
    return m


def time_spec(n_frames: int, mesh: ProcessMesh) -> Tuple[int, int]:
    """This rank's frames [start, stop): an even split of n_frames over the
    axis. Raises unless the axis divides n_frames."""
    n = mesh.size
    if n_frames % n:
        raise ValueError(f"{n_frames} frames do not split evenly over the {n} ranks of the "
                         f"'{mesh.axis}' axis (as JAX's device_put needs): pad the frames to a "
                         f"multiple of {n}")
    c = n_frames // n
    return mesh.index * c, (mesh.index + 1) * c


@dataclass(frozen=True)
class Window:
    """A rank's core [start, stop) of n_frames, widened by `halo` frames on
    each side within [0, n_frames): [lo, hi)."""

    n_frames: int
    start: int
    stop: int
    lo: int
    hi: int
    halo: int

    @property
    def left(self) -> int:
        return self.start - self.lo

    def core(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The core frames of x over the widened window."""
        return x.narrow(dim, self.left, self.stop - self.start)

    def of(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The widened window of x over all n_frames."""
        return x.narrow(dim, self.lo, self.hi - self.lo)


def window(n_frames: int, mesh: ProcessMesh, halo: int) -> Window:
    start, stop = time_spec(n_frames, mesh)
    halo = int(halo)
    return Window(n_frames, start, stop, max(0, start - halo), min(n_frames, stop + halo), halo)


def halo_exchange(core: torch.Tensor, mesh: ProcessMesh, halo: int) -> torch.Tensor:
    """This rank's core [B, c, ...] (time on dim 1) -> its window [B, lo..hi,
    ...], the halo frames taken from the other ranks' cores (the
    neighbours', and further ones where the halo exceeds a core)."""
    n, c = mesh.size, core.shape[1]
    me = window(c * n, mesh, halo)
    if n == 1 or halo == 0:
        return core
    wins = [Window(me.n_frames, i * c, (i + 1) * c, max(0, i * c - halo),
                   min(me.n_frames, (i + 1) * c + halo), halo) for i in range(n)]
    sends, recvs = {}, {}
    for i, w in enumerate(wins):
        if i == mesh.index:
            continue
        # what rank i needs of my core, and what I need of its core
        a, b = max(w.lo, me.start), min(w.hi, me.stop)
        if a < b:
            sends[i] = core.narrow(1, a - me.start, b - a)
        a, b = max(me.lo, w.start), min(me.hi, w.stop)
        if a < b:
            recvs[i] = core.new_empty((core.shape[0], b - a, *core.shape[2:]))
    got = groups.exchange(sends, recvs, mesh)
    parts = [got[i] for i in sorted(got) if i < mesh.index] + [core] + \
        [got[i] for i in sorted(got) if i > mesh.index]
    return torch.cat(parts, dim=1)


def refresh_halo(x: torch.Tensor, mesh: ProcessMesh, win: Window) -> torch.Tensor:
    """x over the widened window with its halo frames replaced by the
    other ranks' cores (the core is kept as it is)."""
    return halo_exchange(win.core(x).contiguous(), mesh, win.halo)


def core_of(x: torch.Tensor, mesh: ProcessMesh, scale: int = 1) -> torch.Tensor:
    """This rank's core of x [B, T x scale, ...], given whole on dim 1."""
    start, stop = time_spec(x.shape[1] // scale, mesh)
    return x[:, start * scale:stop * scale]


def gather_whole(core: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The cores of every rank of the mesh: all frames of all rows."""
    return dp.all_gather_rows(gather_frames(core, mesh), group=mesh.data_group)


def gather_frames(core: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The axis ranks' cores [B, c, ...] -> all n_frames [B, c * n, ...]."""
    return dp.all_gather_rows(core, group=mesh.group, dim=1)


def local_window(x: torch.Tensor, mesh: ProcessMesh, win: Optional[Window],
                 scale: int = 1) -> torch.Tensor:
    """This rank's rows (over `data`) and window (dim 1, frames x scale) of
    x given at the global shape."""
    n_rows = x.shape[0]
    if n_rows % mesh.shape["data"]:
        raise ValueError(f"{n_rows} rows do not split over {mesh.shape['data']} data ranks")
    x = dp.local_rows(x, n_rows // mesh.shape["data"], group=mesh.data_group)
    if win is None:
        return x
    if x.shape[1] != win.n_frames * scale:
        raise ValueError(f"expected {win.n_frames * scale} frames on dim 1 at the global shape, "
                         f"got {x.shape[1]}")
    return x.narrow(1, win.lo * scale, (win.hi - win.lo) * scale)


def shard_longform_batch(batch: Dict, mesh: ProcessMesh, halo: Optional[int] = 0) -> Dict:
    """A host batch at the global shape -> this rank's part: its rows of
    every array over `data`, and of the frame-level arrays (`FRAME_KEYS`)
    its window over `seq` widened by `halo` (None: all frames, for a
    consumer whose reach is the whole score, as the conditioner's).
    Token-level arrays keep every token. `n_frames` gives the global
    frame count."""
    mesh.check_member()
    n_frames = next((np.shape(v)[1] for k, v in batch.items()
                     if k in FRAME_KEYS and np.ndim(v) >= 2), batch.get("n_frames"))
    win = None if halo is None or n_frames is None else window(n_frames, mesh, halo)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)) or np.ndim(v) == 0:
            out[k] = v
            continue
        t = torch.as_tensor(v)
        frame = k in FRAME_KEYS and t.ndim >= 2
        out[k] = local_window(t, mesh, win if frame else None)
        if isinstance(v, np.ndarray):
            out[k] = out[k].numpy()
    if n_frames is not None:
        out["n_frames"] = int(n_frames)
    return out


# ---- each module's halo: its receptive field, from the config ----------------
def denoiser_halo(hp) -> Optional[int]:
    """The DiffNet's reach: one dilation a layer (kernel 3), the rest
    frame-wise; 75 frames at the flagship (20 layers, cycle 4). None for
    the FFT denoiser, whose attention spans every frame: it is gathered."""
    if hp.get("diff_decoder_type", "wavenet") != "wavenet":
        return None
    cycle = int(hp["dilation_cycle_length"])
    return sum(2 ** (i % cycle) for i in range(int(hp["residual_layers"])))


def pe_halo(hp, conv_layers: int = 2) -> int:
    """The PitchExtractor's reach: the Prenet's 3 convs (k=5), the
    ConvStacks' `conv_layers` (k=5) and the predictor's 5 convs
    (`predictor_kernel`, SAME or LEFT); 20 frames at the flagship."""
    k = int(hp["predictor_kernel"])
    pred = k - 1 if hp.get("ffn_padding", "SAME") == "LEFT" else k // 2
    return 3 * 2 + conv_layers * 2 + 5 * pred


def vocoder_halo(hp) -> int:
    """The HiFi-GAN generator's reach in mel frames: conv_pre (k=7 at the
    frame rate), then per stage the transposed conv (max(k - 1 - p, p)
    output samples, p = (k - u) // 2), the noise conv (2 samples of its
    output) and the MRF stage (the widest block: per dilation d, (k - 1) /
    2 * (d + 1) samples for ResBlock1, (k - 1) / 2 * d for ResBlock2), each
    counted at the final rate, and conv_post (k=7); 16 frames at the
    flagship."""
    rates, ks = list(hp["upsample_rates"]), list(hp["upsample_kernel_sizes"])
    hop = int(np.prod(rates))
    res1 = str(hp.get("resblock", "1")) == "1"
    mrf = max(sum((k - 1) // 2 * ((d + 1) if res1 else d) for d in ds)
              for k, ds in zip(hp["resblock_kernel_sizes"], hp["resblock_dilation_sizes"]))
    total = 3 * hop + 3
    for i, (u, k) in enumerate(zip(rates, ks)):
        p = (k - u) // 2
        total += (max(k - 1 - p, p) + 2 + mrf) * int(np.prod(rates[i + 1:]))
    return -(-total // hop)


def halo_for(hp, module: str) -> Optional[int]:
    """The halo, in mel frames, that `module` ("denoiser", "pe",
    "vocoder") needs under `hp`."""
    return {"denoiser": denoiser_halo, "pe": pe_halo, "vocoder": vocoder_halo}[module](hp)
