"""One fp32 train step on the card against the same step on the CPU, with
the step in float64 as the reference of both.

`step_parity` runs a task with `model`, `opt`, `load_state` and
`train_step` (the acoustic tasks, the PitchExtractor); `gan_step_parity`
runs the GAN vocoder task on a voiced batch. `chip_smoke.py` (phases 10,
11 and 12) and `tests/test_torch_gpu.py` call them. The bounds are the CPU
tests' (tests/test_torch_training.py, test_torch_pe_training.py,
test_torch_vocoder.py, test_torch_popcs.py): every loss the step reports
(and their total) within 1e-5 of its own value (of 1e-6 for a value under
it), every
gradient within 1e-4 of its update's largest |gradient|, every parameter
after the update within 1e-6 beyond what the two gradients' difference
moves through Adam's first step (about lr * sign(g): two fp32 gradients of
noise level may differ in sign), the BatchNorm statistics within 1e-6 of
max(|value|, 1).

A ReLU's gradient jumps at 0: where an activation lies within the two
devices' fp32 difference of 0, the two steps take different sides of the
kink, and that one element's whole gradient moves every gradient upstream
of it (a PE step from its initialisation: two such inputs moved a conv
kernel's gradient by 5e-3 of the largest, PERF.md §6). So the card's step
is taken twice: as it falls, and with each ReLU and leaky ReLU pinned to
the side the CPU's step took (`Kinks`, as dropout masks are pinned). The
bounds hold the pinned step; the elements that fell the other way are
counted, and each must lie within `TIE_TOL` of 0 as a share of its
tensor's largest |value| (the two devices' activations agree to about 1e-5
of it), which a fault in the card's forward would break.

The float64 step is the same code on the CPU with the model, the batch and
the pins cast to float64 (`models/common.py`: the fp32 parts compute in
the parameters' dtype); its gradients are the reference. Each fp32 step's
largest gradient distance from it (unpinned) is reported beside the
card-vs-CPU one: a gap that is the card's fault puts the card far from the
reference and the CPU near it; a gap of the fp32 arithmetic puts both
about as far; a flipped kink moves one of them on its own.
"""

from __future__ import annotations

import contextlib
import copy
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LOSS_TOL, GRAD_TOL, PARAM_TOL, STAT_TOL = 1e-5, 1e-4, 1e-6, 1e-6
TIE_TOL = 1e-4
SEED = 3  # the GAN batch, NSF draw and initialisation; the dropout masks


class Kinks:
    """The side of 0 each `F.relu` / `F.leaky_relu` input took in one step,
    in call order: recorded on one run, then pinned on another, which counts
    the elements that would have fallen the other way."""

    def __init__(self):
        self.sides: List[torch.Tensor] = []
        self.flips, self.worst_tie = 0, 0.0

    @contextlib.contextmanager
    def _patched(self, side):
        relu, leaky = F.relu, F.leaky_relu
        F.relu = lambda x, inplace=False: torch.where(side(x), x, torch.zeros_like(x))
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: torch.where(
            side(x), x, x * negative_slope)
        try:
            yield self
        finally:
            F.relu, F.leaky_relu = relu, leaky

    def record(self):
        """The same values and gradients as torch's (x > 0 takes the linear side)."""
        def side(x):
            pos = x > 0
            self.sides.append(pos.cpu())
            return pos
        return self._patched(side)

    def pin(self):
        recorded = iter(self.sides)

        def side(x):
            pos = next(recorded).to(x.device)
            flip = pos != (x > 0)
            n = int(flip.sum())
            if n:
                self.flips += n
                tie = float(x.detach()[flip].abs().max()) / float(x.detach().abs().max())
                self.worst_tie = max(self.worst_tie, tie)
            return pos
        return self._patched(side)


@dataclass
class Step:
    """What one train step left: its losses, and per update (one, or the
    GAN's two) the gradients and the parameters after it, as flat flax trees."""

    losses: Dict[str, float]
    grads: List[Dict[str, np.ndarray]]
    params: List[Dict[str, np.ndarray]]
    lr: float
    max_norm: float = 0.0
    stats: Dict[str, np.ndarray] = field(default_factory=dict)


def _f64(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.double() if v.is_floating_point() else v for k, v in tensors.items()}


def _is_stat(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in ("mean", "var")


def pin_dropout(model: torch.nn.Module) -> None:
    """The same dropout masks on any device: each `Dropout` of `model`
    draws its masks on the CPU from one generator, per input shape, in the
    order of first calls."""
    from bisinger_tpu_torch.models.common import Dropout, div

    g = torch.Generator().manual_seed(SEED)
    for d in model.modules():
        if not isinstance(d, Dropout):
            continue
        masks = {}

        def forward(x, d=d, masks=masks):
            if not d.training or d.rate == 0.0:
                return x
            if x.shape not in masks:
                masks[x.shape] = torch.rand(x.shape, generator=g) < 1.0 - d.rate
            return torch.where(masks[x.shape].to(x.device), div(x, 1.0 - d.rate),
                               torch.zeros((), dtype=x.dtype, device=x.device))

        d.forward = forward


def _task_step(make_task, params, batch, pins, device, fp64: bool,
               kinks=contextlib.nullcontext()) -> Step:
    from bisinger_tpu_torch.data.dataset import batch_to_device
    from bisinger_tpu_torch.weights import export_flax_params

    task = make_task(device)
    task.load_state(params)
    if fp64:
        task.model.double()
        task.opt = task.build_optimizer()
    pin_dropout(task.model)
    b = batch_to_device(batch, device)
    p = {k: v.to(device) for k, v in pins.items()}
    if fp64:
        b, p = _f64(b), _f64(p)
    with kinks:
        out = task.train_step(b, **p)
    holder = copy.deepcopy(task.model)
    for q, g in zip(task.model.parameters(), holder.parameters()):
        g.data = torch.zeros_like(q) if q.grad is None else q.grad.detach().clone()
    after = export_flax_params(task.model)
    grads = {k: v for k, v in export_flax_params(holder).items() if not _is_stat(k)}
    return Step({k: float(v) for k, v in out.items() if k != "grad_norm"}, [grads],
                [{k: v for k, v in after.items() if not _is_stat(k)}], task.opt.lr_fn(0),
                task.opt.max_norm, {k: v for k, v in after.items() if _is_stat(k)})


def _worst_grad(a: Step, b: Step) -> Tuple[float, str]:
    """The largest |a - b| of a gradient, as a share of its update's largest
    |b|: (share, key)."""
    worst = (0.0, "")
    for ga, gb in zip(a.grads, b.grads):
        gmax = max(float(np.abs(v).max()) for v in gb.values())
        for k in gb:
            worst = max(worst, (float(np.abs(ga[k].astype(np.float64) - gb[k]).max()) / gmax,
                                k))
    return worst


def _clip(step: Step, grads) -> float:
    if not step.max_norm:
        return 1.0
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in grads.values()))
    return min(1.0, step.max_norm / norm)


def compare(card: Step, cpu: Step, kinks: Kinks, raw: Step, ref: Optional[Step] = None
            ) -> Tuple[bool, str]:
    """The card's step with the CPU's kinks (`card`) against the CPU's with
    the bounds above; the kinks that fell the other way on the card, and
    the card's step as it fell (`raw`); with `ref` (the float64 step), each
    fp32 step's gradient distance from it. (ok, text)."""
    loss_rel, loss_key = max((abs(card.losses[k] - v) / max(abs(v), 1e-6), k)
                             for k, v in cpu.losses.items())
    grad_rel, grad_key = _worst_grad(card, cpu)
    u = lambda x: x / (np.abs(x) + 1e-8)  # noqa: E731
    excess = 0.0
    for gc, pc, gp, pp in zip(card.grads, card.params, cpu.grads, cpu.params):
        cc, cp = _clip(card, gc), _clip(cpu, gp)
        for k in pp:
            carried = cpu.lr * np.abs(u(cc * gc[k].astype(np.float64))
                                      - u(cp * gp[k].astype(np.float64)))
            excess = max(excess, float((np.abs(pc[k].astype(np.float64) - pp[k])
                                        - carried).max()))
    stat_rel = max((float(np.abs(card.stats[k].astype(np.float64) - v).max())
                    / max(float(np.abs(v).max()), 1.0) for k, v in cpu.stats.items()),
                   default=0.0)
    ok = (loss_rel <= LOSS_TOL and grad_rel <= GRAD_TOL and excess <= PARAM_TOL
          and stat_rel <= STAT_TOL and kinks.worst_tie <= TIE_TOL)
    raw_rel, raw_key = _worst_grad(raw, cpu)
    text = (f"losses {loss_rel:.2e} of their own value ({loss_key}; tol {LOSS_TOL:g}), worst "
            f"grad {grad_rel:.2e} of its update's largest ({grad_key}; tol {GRAD_TOL:g}), "
            f"params {excess:.2e} beyond Adam's carry (tol {PARAM_TOL:g})"
            + (f", BatchNorm statistics {stat_rel:.2e} (tol {STAT_TOL:g})" if cpu.stats else "")
            + f"; {kinks.flips} of {sum(int(m.numel()) for m in kinks.sides)} ReLU inputs on "
            f"the other side of 0 on the card, the largest {kinks.worst_tie:.2e} of its "
            f"tensor's largest |value| (tol {TIE_TOL:g}); unpinned, the worst grad "
            f"{raw_rel:.2e} ({raw_key})")
    if ref is not None:
        (rc, kc), (rp, kp) = _worst_grad(raw, ref), _worst_grad(cpu, ref)
        text += (f"; from the float64 step: card's grads {rc:.2e} ({kc}), CPU's {rp:.2e} "
                 f"({kp})")
    return ok, text


def step_parity(make_task: Callable, params: Dict[str, np.ndarray], batch, pins: Dict,
                dev, reference: bool = False) -> Tuple[bool, str]:
    """One fp32 step of the task `make_task(device)` builds, from `params`
    on `batch` (numpy, collated), on the CPU, then on `dev` as it falls and
    with the CPU's kinks; the dropout masks pinned (`pin_dropout`), `pins`
    go to train_step. With `reference`, also the float64 step on the CPU.
    The task is built once, on the CPU, and each step takes a copy of it to
    its device. (ok, text)."""
    cpu_dev, kinks = torch.device("cpu"), Kinks()
    base = make_task(cpu_dev)
    copy_to = lambda d: copy.deepcopy(base).to(d)  # noqa: E731
    cpu = _task_step(copy_to, params, batch, pins, cpu_dev, False, kinks.record())
    raw = _task_step(copy_to, params, batch, pins, dev, False)
    card = _task_step(copy_to, params, batch, pins, dev, False, kinks.pin())
    ref = _task_step(copy_to, params, batch, pins, cpu_dev, True) if reference else None
    return compare(card, cpu, kinks, raw, ref)


def gan_batch(hop: int):
    """A voiced GAN batch (B=2, 32 frames of `hop` samples; f0 200-300 Hz on
    every frame) and its NSF draw: ({"mels", "f0", "wav"}, {"phase",
    "noise"}), CPU tensors."""
    g = torch.Generator().manual_seed(SEED)
    batch = {"mels": torch.randn(2, 32, 80, generator=g) * 0.5 - 4,
             "f0": 200.0 + 100.0 * torch.rand(2, 32, generator=g),
             "wav": 0.1 * torch.randn(2, 32 * hop, generator=g)}
    pins = {"phase": torch.rand(2, 9, generator=g),
            "noise": torch.randn(2, 32 * hop, 9, generator=g)}
    return batch, pins


def gan_to_float64(task) -> None:
    """A `HifiGanTask`'s networks, trainable leaves and optimizers in
    float64, from the same values."""
    task.generator.double()
    task.disc.double()
    for ps in (task.gen_params, task.disc_params):
        for p in ps.values():
            p.data = p.data.double()
    task._new_optimizers()


def _gan_step(task, batch, pins, fp64: bool, kinks=contextlib.nullcontext()) -> Step:
    """One step of `task` (a HifiGanTask not yet stepped) on its device."""
    from bisinger_tpu_torch.training import weight_norm as wn

    device = task.device
    if fp64:
        gan_to_float64(task)
    cast = _f64 if fp64 else (lambda d: d)
    with kinks:
        out = task.train_step(cast({k: v.to(device) for k, v in batch.items()}),
                              **cast({k: v.to(device) for k, v in pins.items()}))
    grads, params = [], []
    for m, ps in ((task.disc, task.disc_params), (task.generator, task.gen_params)):
        grads.append(wn.flax_tree(m, {k: p.grad for k, p in ps.items()}))
        params.append(wn.flax_tree(m, ps))
    return Step({k: float(v) for k, v in out.items()}, grads, params, task.gen_opt.lr_fn(0))


def gan_step_parity(hp, dev, reference_device="cpu") -> Tuple[bool, str]:
    """One fp32 GAN step (the discriminators' update, then the generator's)
    from the same initialisation, voiced batch (B=2, 32 frames at the
    generator's hop) and NSF draw on the CPU, then on `dev` as it falls and
    with the CPU's kinks, and in float64 on `reference_device` (on the card
    a reading of the fp32 arithmetic's gap only: it shares any fault of the
    card's; None: no float64 step, the reading left out). The task is built
    once, on the CPU, and each step takes a copy of it to its device: one
    initialisation, drawn once. (ok, text)."""
    from bisinger_tpu_torch.training.vocoder_task import HifiGanTask

    hop = int(np.prod(hp["upsample_rates"])) * int(hp.get("vocoder_multiband", 1) or 1)
    batch, pins = gan_batch(hop)
    cpu_dev, kinks, secs = torch.device("cpu"), Kinks(), []
    base = HifiGanTask(hp, device=cpu_dev, seed=SEED)

    def timed(device, *args):
        t0 = time.perf_counter()
        step = _gan_step(copy.deepcopy(base).to(device), *args)
        secs.append(time.perf_counter() - t0)  # each step ends in a copy to the host
        return step

    cpu = timed(cpu_dev, batch, pins, False, kinks.record())
    raw = timed(dev, batch, pins, False)
    card = timed(dev, batch, pins, False, kinks.pin())
    ref = None if reference_device is None else timed(torch.device(reference_device), batch,
                                                      pins, True)
    ok, text = compare(card, cpu, kinks, raw, ref)
    if ref is not None:
        text += " (float64 on the %s)" % (
            "CPU" if torch.device(reference_device).type == "cpu" else "card")
    return ok, (f"{text}; disc_loss "
                f"{card.losses['disc_loss']:.6f} vs CPU {cpu.losses['disc_loss']:.6f}, gen_loss {card.losses['gen_loss']:.6f} vs CPU "
                f"{cpu.losses['gen_loss']:.6f}; seconds a step (CPU, card, card pinned"
                f"{'' if ref is None else ', float64'}) " + ", ".join(f"{x:.1f}" for x in secs))
