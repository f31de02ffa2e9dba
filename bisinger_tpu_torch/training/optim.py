"""The optimizer and learning-rate schedules of the training tasks
(counterpart of `bisinger_tpu/training/optim.py:26-156` and of the GAN
vocoder's `optax.adamw`), written for the port and held to optax's numbers:

  - `rsqrt_schedule`: warmup * rsqrt decay * hidden^-0.5, floored at 1e-7
    (the FFT-Singer stage); `step_decay_schedule`: halved every
    `decay_steps` (the diffusion stage). Both evaluate in fp32.
  - `AdamW.step`: optax's chain clip_by_global_norm -> adamw, in
    multi-tensor ops (a few launches a step for all the parameters): the
    gradients scaled by max_norm / norm when their global norm reaches
    max_norm; Adam moments with bias correction, eps 1e-8 outside the
    square root, weight decay on every parameter; the schedule read at the
    count of updates before this one, so the first update uses its value
    at 0. A parameter that got no gradient counts as a zero gradient, as
    JAX differentiates every leaf.
  - `accumulate_grad_batches` (an int, or a dict of epoch -> factor):
    optax.MultiSteps: the mean of k mini-step gradients goes through the
    chain once every k mini-steps; every mini-step counts as a step.
  - `frozen` parameters (DiffSpeech's conditioner but its predictors,
    `predictor_only_frozen`): `optax.masked(optax.set_to_zero())` on both
    sides of the chain: their gradients count as zero (in the clip's norm
    too), their Adam moments stay zero and they do not move, weight decay
    included.
  - schedule "vocoder": `optax.adamw(vocoder_lr, vocoder_adam_b1,
    vocoder_adam_b2)` of the GAN task (`bisinger_tpu/training/
    vocoder_task.py:86-88`): a constant rate (default 2e-4), betas 0.8 and
    0.99 by default, optax's own weight decay 1e-4 on every leaf (biases and
    weight-norm g's too), no clipping and no accumulation.
  - `RAdam`: the JAX package's `radam` (Rectified Adam), wired into no task.

Data-parallel, the optimizer runs on the gradients already summed over the
ranks (`training/tasks.py`), so the clip, the moments and the accumulation
are the same on every rank; the trainer checks that the ranks' states agree.
"""

from __future__ import annotations

import bisect
from collections.abc import Mapping
from typing import Callable, Dict, Iterable, Optional, Set

import numpy as np
import torch

F32 = np.float32


def rsqrt_schedule(hp) -> Callable[[int], float]:
    lr, warmup, hidden = F32(hp["lr"]), hp["warmup_updates"], hp["hidden_size"]

    def schedule(step: int) -> float:
        step = max(int(step), 1)
        w = min(F32(step) / F32(warmup), F32(1.0))
        rsqrt_decay = F32(1.0) / np.sqrt(F32(max(warmup, step)))
        return float(max(lr * w * rsqrt_decay * F32(hidden ** -0.5), F32(1e-7)))

    return schedule


def step_decay_schedule(hp) -> Callable[[int], float]:
    lr = hp["lr"]
    if lr == 2.0 and "lr" not in hp.get("_explicit_keys", ()):
        # lr=2.0 inherited from the defaults is the rsqrt schedule's scale;
        # as a step-decay rate it diverges: the diffusion recipes' 0.001
        print("| WARNING: lr=2.0 inherited from the rsqrt-scale default "
              "with the step-decay schedule would diverge; using the "
              "reference diffusion default 0.001 (set lr explicitly to "
              "override)", flush=True)
        lr = 0.001
    lr, decay_steps = F32(lr), F32(hp["decay_steps"])

    def schedule(step: int) -> float:
        return float(lr * F32(0.5) ** np.floor(F32(step) / decay_steps))

    return schedule


def accum_schedule(spec: Dict, steps_per_epoch: int) -> Callable[[int], int]:
    """Per-epoch accumulation factors (reference
    `GradientAccumulationScheduler`, `pl_utils.py:256-280`): `spec` maps a
    1-indexed epoch to a factor, the latest scheduled epoch's applies.
    Returns the factor as a function of the count of optimizer updates,
    the epoch boundaries counted in updates (steps_per_epoch // factor a
    epoch)."""
    if not spec:
        raise TypeError("Empty dict cannot be interpreted correct")
    sched = {}
    for k, v in dict(spec).items():
        if isinstance(k, str) and k.lstrip("-").isdigit():
            k = int(k)
        if not isinstance(k, int) or not isinstance(v, int):
            raise TypeError("All epoches and accumulation factor must be integers")
        sched[k] = v
    if min(sched) < 1:
        raise IndexError(f"Epochs indexing from 1, epoch {min(sched)} invalid")
    sched.setdefault(1, 1)
    epochs = sorted(sched)
    thresholds, factors, updates = [], [], 0
    for i, e in enumerate(epochs):
        f = max(sched[e], 1)
        factors.append(f)
        if i + 1 == len(epochs):
            break
        updates += (epochs[i + 1] - e) * max(steps_per_epoch // f, 1)
        thresholds.append(updates)

    def every_k(update_count: int) -> int:
        return factors[bisect.bisect_right(thresholds, int(update_count))]

    return every_k


class AdamW:
    """optax's clip_by_global_norm -> adamw, under MultiSteps when
    accumulating, over named parameters (their state_dict names)."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], hp, schedule: str = "rsqrt",
                 steps_per_epoch: Optional[int] = None, frozen: Iterable[str] = ()):
        self.params = dict(params)
        self.frozen = set(frozen)
        unknown = self.frozen - set(self.params)
        if unknown:
            raise KeyError(f"frozen names no parameter: {sorted(unknown)[:4]}")
        self.eps = 1e-8
        if schedule == "vocoder":
            lr = float(hp.get("vocoder_lr", 2e-4))
            self.lr_fn = lambda _: lr
            self.max_norm = 0.0
            self.b1 = float(hp.get("vocoder_adam_b1", 0.8))
            self.b2 = float(hp.get("vocoder_adam_b2", 0.99))
            self.weight_decay = 1e-4  # optax.adamw's default
            accum = 1
        else:
            self.lr_fn = rsqrt_schedule(hp) if schedule == "rsqrt" else step_decay_schedule(hp)
            self.max_norm = float(hp.get("clip_grad_norm", 0) or 0)
            self.b1 = float(hp["optimizer_adam_beta1"])
            self.b2 = float(hp["optimizer_adam_beta2"])
            self.weight_decay = float(hp.get("weight_decay", 0.0) or 0.0)
            accum = hp.get("accumulate_grad_batches", 1)
        if isinstance(accum, Mapping):
            # the per-epoch form needs batches per epoch; without them (a task
            # outside a trainer) it does not accumulate, as in the JAX package
            self.every_k = (accum_schedule(accum, steps_per_epoch)
                            if steps_per_epoch is not None else None)
        else:
            self.every_k = (lambda _: int(accum)) if accum and int(accum) > 1 else None
        self.count = 0  # optimizer updates applied (adam's and the schedule's count)
        self.mini_step = 0
        self.gradient_step = 0
        zeros = lambda: {k: torch.zeros_like(p) for k, p in self.params.items()}  # noqa: E731
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.every_k is not None else None
        self._zero_grads = {}  # the zero gradient of each parameter that got none

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    def grads(self):
        """The parameters' gradients in order, a cached zero for each that
        got none."""
        out = []
        for k, p in self.params.items():
            if p.grad is None:
                if k not in self._zero_grads:
                    self._zero_grads[k] = torch.zeros_like(p)
                out.append(self._zero_grads[k])
            else:
                out.append(p.grad)
        return out

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        """sqrt of the sum of every gradient's squares, as a device scalar."""
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def step(self) -> bool:
        """One mini-step from the parameters' .grad; returns whether the
        parameters changed. Multi-tensor (`torch._foreach_*`) ops, each the
        same elementwise expression as optax's."""
        grads = self.grads()
        if self.frozen:
            grads = [torch.zeros_like(g) if k in self.frozen else g
                     for k, g in zip(self.params, grads)]
        if self.every_k is not None:
            k = self.every_k(self.gradient_step)
            acc = list(self.acc.values())
            delta = torch._foreach_sub(grads, acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(acc, delta)
            if self.mini_step != k - 1:
                self.mini_step += 1
                return False
            grads = torch._foreach_mul(acc, 1.0)
            torch._foreach_zero_(acc)
            self.mini_step = 0
            self.gradient_step += 1
        if self.max_norm > 0:
            norm = self.global_norm(grads)
            # chosen on the device, no host sync: 1 under max_norm, else max_norm / norm
            scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                self.max_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        count_inc = self.count + 1
        bc1 = float(F32(1.0) - F32(self.b1) ** F32(count_inc))
        bc2 = float(F32(1.0) - F32(self.b2) ** F32(count_inc))
        params, mu, nu = (list(d.values()) for d in (self.params, self.mu, self.nu))
        if self.frozen:  # the frozen leaves' moments stay zero, the leaves unmoved
            live = [i for i, k in enumerate(self.params) if k not in self.frozen]
            grads, params, mu, nu = ([x[i] for i in live] for x in (grads, params, mu, nu))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        upd = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -self.lr_fn(self.count))
        torch._foreach_add_(params, upd)
        self.count = count_inc
        return True

    def state_dict(self) -> Dict:
        out = {"count": self.count, "mini_step": self.mini_step,
               "gradient_step": self.gradient_step}
        for part in ("mu", "nu", "acc"):
            for k, v in (getattr(self, part) or {}).items():
                out[f"{part}/{k}"] = v
        return out

    def load_state_dict(self, state: Dict) -> None:
        for key in ("count", "mini_step", "gradient_step"):
            setattr(self, key, int(state[key]))
        for part in ("mu", "nu", "acc"):
            for k, v in (getattr(self, part) or {}).items():
                v.copy_(torch.as_tensor(state[f"{part}/{k}"]))


class RAdam:
    """Rectified Adam (`bisinger_tpu/training/optim.py:171-222`, the
    reference's optimizer of the PWG recipe), over named parameters, from
    their .grad: Adam's moments; while the rectification term is undefined
    (rho_t <= 4, the first steps) the update is the bias-corrected first
    moment alone, after it rect * m_hat / (sqrt(v / (1 - b2^t)) + eps), the
    rectification's radicand clipped at 0 and its denominator floored at
    1e-8. The step's scalars are fp32, as JAX's; the rate is read at the
    count of updates including this one. No task uses it, as none does in
    the JAX package."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], learning_rate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = dict(params)
        self.lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    def scalars(self, count: int):
        """(use the adapted step, rect, 1 - b1^t, 1 - b2^t) at step `count`, fp32."""
        t, b1, b2 = F32(count), F32(self.b1), F32(self.b2)
        beta2_t = b2 ** t
        rho_inf = F32(2.0 / (1.0 - self.b2) - 1.0)
        rho_t = rho_inf - F32(2.0) * t * beta2_t / (F32(1.0) - beta2_t)
        ratio = (rho_t - F32(4.0)) * (rho_t - F32(2.0)) * rho_inf / max(
            (rho_inf - F32(4.0)) * (rho_inf - F32(2.0)) * rho_t, F32(1e-8))
        rect = np.sqrt(max(ratio, F32(0.0)))
        return bool(rho_t > 4.0), float(rect), float(F32(1.0) - b1 ** t), \
            float(F32(1.0) - beta2_t)

    @torch.no_grad()
    def step(self) -> None:
        count = self.count + 1
        adapt, rect, bc1, bc2 = self.scalars(count)
        lr = float(self.lr_fn(count))
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m = self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            v = self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            upd = m / bc1
            if adapt:
                upd = rect * upd / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.add_(-lr * upd)
        self.count = count


def predictor_only_frozen(params: Dict[str, torch.nn.Parameter]) -> Set[str]:
    """DiffSpeech's policy (`optim.py:159-170`): the names of the
    conditioner's (`fs2.`) parameters outside its predictors
    (`*predictor*`); the denoiser and the predictors train."""
    def frozen(name: str) -> bool:
        parts = name.split(".")
        return "fs2" in parts and not any("predictor" in p for p in parts)

    return {k for k in params if frozen(k)}
