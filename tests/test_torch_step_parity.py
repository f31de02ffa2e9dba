"""The card-vs-CPU step check (`bisinger_tpu_torch/tools/step_parity.py`)
on the CPU: the kink record leaves torch's ReLUs as they are, a pinned run
takes the recorded sides and counts the flips, a step held against itself
passes, and the float64 reference step computes the fp32 step's function
(the GAN step's float64 run against JAX's is in test_torch_vocoder.py).
Tolerances are stated at each assertion."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bisinger_tpu_torch.tools import step_parity as sp
from bisinger_tpu_torch.training.tasks import PitchExtractionTask
from bisinger_tpu_torch.weights import export_flax_params

from torch_port_helpers import hparams

CPU = torch.device("cpu")


@pytest.mark.parametrize("fn", ["relu", "leaky_relu"])
def test_kink_record_keeps_torch_values_and_gradients(fn):
    """Under `Kinks.record` F.relu / F.leaky_relu give torch's values and
    gradients exactly, zeros included; the sides are kept in call order."""
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    x[0, :5] = 0.0
    args = (0.1,) if fn == "leaky_relu" else ()
    a = x.clone().requires_grad_()
    getattr(F, fn)(a, *args).pow(2).sum().backward()
    kinks = sp.Kinks()
    b = x.clone().requires_grad_()
    with kinks.record():
        y = getattr(F, fn)(b, *args)
    y.pow(2).sum().backward()
    assert torch.equal(y, getattr(F, fn)(x, *args)) and torch.equal(a.grad, b.grad)
    assert len(kinks.sides) == 1 and torch.equal(kinks.sides[0], x > 0)
    assert F.relu is torch.nn.functional.relu and getattr(F, fn).__module__ != sp.__name__


def test_pinned_kinks_take_the_recorded_side_and_count_the_flips():
    """A pinned run takes the recorded side of each input, so the gradient
    passes where the recorded run's did; it counts the inputs on the other
    side and the largest of them as a share of its tensor's largest |value|."""
    x = torch.tensor([1.0, -2.0, 1e-6, -4.0, 3.0])
    kinks = sp.Kinks()
    with kinks.record():
        F.relu(x)
    moved = torch.tensor([1.0, -2.0, -2e-6, 1e-6, 3.0], requires_grad=True)
    with kinks.pin():
        y = F.relu(moved)
    y.sum().backward()
    assert torch.equal(moved.grad, torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0]))
    assert kinks.flips == 2 and kinks.worst_tie == pytest.approx(2e-6 / 3.0)


def _pe_batch(b=2, t=32, seed=0):
    r = np.random.default_rng(seed)
    mels = (r.standard_normal((b, t, 80)) * 0.5 - 3).astype(np.float32)
    mel2ph = np.ones((b, t), np.int64)
    mel2ph[0, -7:] = 0
    mels[mel2ph == 0] = 0.0
    f0 = (7.5 + 0.5 * r.standard_normal((b, t))).astype(np.float32)
    uv = (r.uniform(size=(b, t)) < 0.25).astype(np.float32)
    return dict(mels=mels, mel2ph=mel2ph, f0=f0, uv=uv)


def _pe_task():
    _, php = hparams(pitch_type="frame", use_uv=True, pitch_loss="l1")
    return lambda d: PitchExtractionTask(php, device=d)


def test_pe_step_against_itself_and_its_float64_step():
    """`step_parity` with the CPU in the card's place passes with no flip;
    the PitchExtractor's float64 step (the model cast to float64) is within
    the suite's 1e-4 of the fp32 step's largest gradient (measured 3.0e-5)
    and its loss within 1e-6."""
    make = _pe_task()
    params = export_flax_params(make(CPU).model)
    batch = _pe_batch()
    ok, text = sp.step_parity(make, params, batch, {}, CPU, reference=True)
    assert ok and " 0 of " in text, text
    f32 = sp._task_step(make, params, batch, {}, CPU, False)
    f64 = sp._task_step(make, params, batch, {}, CPU, True)
    assert all(v.dtype == np.float32 for v in f32.grads[0].values())
    assert abs(f32.losses["total_loss"] - f64.losses["total_loss"]) <= 1e-6 * abs(
        f64.losses["total_loss"])
    assert sp._worst_grad(f32, f64)[0] <= 1e-4


def test_compare_fails_a_gradient_moved_past_the_bound():
    """The check is not vacuous: one gradient element moved by 2e-4 of the
    largest fails it, and a flipped kink far from 0 fails it too."""
    make = _pe_task()
    params = export_flax_params(make(CPU).model)
    step = sp._task_step(make, params, _pe_batch(), {}, CPU, False)
    kinks = sp.Kinks()
    assert sp.compare(step, step, kinks, step)[0]
    moved = sp.Step(step.losses, [dict(step.grads[0])], step.params, step.lr, step.max_norm,
                    step.stats)
    gmax = max(float(np.abs(v).max()) for v in step.grads[0].values())
    k = next(iter(moved.grads[0]))
    moved.grads[0][k] = moved.grads[0][k] + np.float32(2e-4 * gmax)
    assert not sp.compare(moved, step, kinks, moved)[0]
    kinks.worst_tie = 1e-3
    assert not sp.compare(step, step, kinks, step)[0]
