"""The port's learning-rate schedulers (paddle_tpu_torch/optimizer/lr.py)
against the JAX package's (paddle_tpu/optimizer/lr.py): the same
constructor arguments, 60 ``step()`` calls, ``last_lr`` equal as floats
after each (both are plain Python doubles computed by the same formulas,
so the tolerance is none); and the ``state_dict`` round trip: a fresh
scheduler given the state of one stepped 25 times continues as it does.
Also ``get_lr`` / ``set_lr`` / ``set_lr_scheduler`` and the optimizer
state dict's ``LR_Scheduler`` key."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as port_lr

STEPS = 60


#: name -> factory(lr module): all 17 schedulers, some in two settings
CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 20, 40],
                                                 [1.0, 0.5, 0.1, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.5, decay_steps=30, end_lr=0.01, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=17, end_lr=0.01, power=1.5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.3, T_max=40), warmup_steps=10,
        start_lr=0.0, end_lr=0.3),
    "LinearWarmup-float": lambda m: m.LinearWarmup(
        0.3, warmup_steps=10, start_lr=0.01, end_lr=0.3),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.93),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [10, 25, 50],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(
        0.5, lambda e: 1.0 / (1 + 0.1 * e)),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=25, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda m:
        m.CosineAnnealingWarmRestarts(0.5, T_0=7, T_mult=2,
                                      eta_min=0.001),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.5, mode="min", factor=0.5, patience=3, cooldown=2),
    "OneCycleLR": lambda m: m.OneCycleLR(1.0, total_steps=50),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.95 if e % 2 else 0.99),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                     mode="triangular2"),
    "CyclicLR-scale_fn": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, step_size_down=9,
        scale_fn=lambda c: 1.0 / c),
    "LinearLR": lambda m: m.LinearLR(0.5, total_steps=30,
                                     start_factor=0.25),
}
#: ReduceOnPlateau's metrics: falls, then a plateau with noise, then falls
METRICS = [10.0 - 0.2 * i if i < 15 else 7.0 + 0.01 * math.sin(i)
           for i in range(STEPS)]


def _step(s, i):
    if isinstance(s, (jax_lr.ReduceOnPlateau, port_lr.ReduceOnPlateau)):
        s.step(METRICS[i])
    else:
        s.step()


def _trajectory(s, n=STEPS, start=0):
    out = [s.last_lr]
    for i in range(start, start + n):
        _step(s, i)
        out.append(s.last_lr)
    return out


def test_every_scheduler_is_ported():
    jax_names = {n for n, c in vars(jax_lr).items()
                 if isinstance(c, type) and issubclass(c, jax_lr.LRScheduler)
                 and c is not jax_lr.LRScheduler}
    port_names = {n for n, c in vars(port_lr).items()
                  if isinstance(c, type)
                  and issubclass(c, port_lr.LRScheduler)
                  and c is not port_lr.LRScheduler}
    assert len(jax_names) == 17 and port_names == jax_names
    assert {name.split("-")[0] for name in CASES} == jax_names


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_matches_jax(name):
    want = _trajectory(CASES[name](jax_lr))
    got = _trajectory(CASES[name](port_lr))
    assert got == want
    assert all(isinstance(v, float) and np.isfinite(v) for v in got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_state_dict_round_trip(name):
    """Stepped 25 times, saved, loaded into a fresh scheduler: the next 35
    steps equal the uninterrupted run's, and the saved state is the JAX
    package's."""
    a = CASES[name](port_lr)
    _trajectory(a, 25)
    state = a.state_dict()
    j = CASES[name](jax_lr)
    _trajectory(j, 25)
    assert state == j.state_dict()
    b = CASES[name](port_lr)
    b.set_state_dict(dict(state))
    assert b.last_lr == a.last_lr
    assert _trajectory(b, 35, start=25) == _trajectory(a, 35, start=25)


def test_optimizer_reads_and_saves_the_schedule():
    """``get_lr`` reads the schedule's ``last_lr``; ``set_lr`` and
    ``set_lr_scheduler`` replace it; the state dict carries the schedule
    under ``LR_Scheduler`` (the JAX package's key) and restores it."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = port_lr.StepDecay(0.5, step_size=2, gamma=0.1)
    opt = AdamW(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.5
    for _ in range(3):
        sched.step()
    assert opt.get_lr() == sched.last_lr == 0.5 * 0.1
    sd = opt.state_dict()
    assert sd["LR_Scheduler"] == sched.state_dict()
    assert float(sd["step_tensor"]) == 0.0
    j = paddle.optimizer.AdamW(
        learning_rate=jax_lr.StepDecay(0.5, step_size=2, gamma=0.1),
        parameters=[paddle.create_parameter([3], dtype="float32")])
    assert set(j.state_dict()) - {"moment1.0", "moment2.0"} == \
        set(sd) - {"moment1.0", "moment2.0"}
    fresh = port_lr.StepDecay(0.5, step_size=2, gamma=0.1)
    opt2 = AdamW(learning_rate=fresh, parameters=[p])
    opt2.set_state_dict(sd)
    assert fresh.last_epoch == 3 and opt2.get_lr() == opt.get_lr()
    opt2.set_lr(0.25)
    assert opt2.get_lr() == 0.25
    opt2.set_lr_scheduler(port_lr.ExponentialDecay(0.1, gamma=0.5))
    assert opt2.get_lr() == 0.1
