"""Fixed-step explicit ODE integrators (the port of the JAX package's
`models/ode.py`): Euler, midpoint and RK4, as a Python loop over the grid,
which is a host numpy array or a tensor (an exported program's input: the
loop unrolls over its fixed length).

The grid is fixed, so every evaluation time is known before integrating
(Euler evaluates at t_i; midpoint adds t_i + dt/2; RK4 adds t_i + dt, and its
k2 and k3 share the half-step time). `schedule_fn` precomputes time-only
conditioning for the whole grid, and the flow function receives the slice
for each stage's time.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

FlowFn = Callable[..., torch.Tensor]  # (t, y [, sched]) -> dy/dt

# evaluation-time offsets (in units of dt) per stage, i.e. the schedule slots;
# RK4's k2 and k3 share the half-step slot
_STAGE_OFFSETS = {
    "euler": (0.0,),
    "midpoint": (0.0, 0.5),
    "rk4": (0.0, 0.5, 1.0),
}


def _euler_step(func: FlowFn, y, t, dt, half, sixth, sch):
    return y + dt * func(t, y, sch[0])


def _midpoint_step(func: FlowFn, y, t, dt, half, sixth, sch):
    k1 = func(t, y, sch[0])
    k2 = func(t + half, y + half * k1, sch[1])
    return y + dt * k2


def _rk4_step(func: FlowFn, y, t, dt, half, sixth, sch):
    k1 = func(t, y, sch[0])
    k2 = func(t + half, y + half * k1, sch[1])
    k3 = func(t + half, y + half * k2, sch[1])
    k4 = func(t + dt, y + dt * k3, sch[2])
    return y + sixth * (k1 + 2 * k2 + 2 * k3 + k4)


_STEPPERS = {"euler": _euler_step, "midpoint": _midpoint_step, "rk4": _rk4_step}

METHODS = tuple(_STEPPERS)


def _slot(sched, i: int):
    if sched is None:
        return None
    if isinstance(sched, dict):
        return {k: v[i] for k, v in sched.items()}
    return sched[i]


def _step_scalars(t):
    """Each step's (t_i, dt_i, dt_i / 2, dt_i / 6), all float32: Python
    floats from a numpy grid, 0-d tensors from a tensor grid (a traced
    program's input). Both round alike, so the two grids integrate to the
    same bits."""
    if isinstance(t, torch.Tensor):
        t = t.float()
        dt = t[1:] - t[:-1]
        # a tensor divisor: CUDA divides by a Python scalar as a product with its reciprocal, off by an ulp
        cols = (t[:-1], dt, 0.5 * dt, dt / torch.full_like(dt, 6.0))
        return list(zip(*(c.unbind() for c in cols))), t[:-1], dt
    t = np.asarray(t, dtype=np.float32)
    dt = t[1:] - t[:-1]
    cols = (t[:-1], dt, np.float32(0.5) * dt, dt / np.float32(6.0))
    return [tuple(map(float, row)) for row in zip(*cols)], t[:-1], dt


def odeint(
    func: FlowFn,
    y0: torch.Tensor,
    t: np.ndarray | torch.Tensor,
    method: str = "rk4",
    return_trajectory: bool = True,
    schedule_fn: Callable | None = None,
) -> torch.Tensor:
    """Integrate dy/dt = func(t, y) over the float32 grid `t`: a host numpy
    array (the live sampler), or a tensor (a traced program, whose grid is
    an input; nothing here reads its values on the host).

    Returns [len(t), *y0.shape] with y0 first, or with
    return_trajectory=False only the final state as [1, *y0.shape].

    `schedule_fn(times [m] float32, of the grid's kind) -> tensor or dict of
    tensors with leading axis m`; func is then called as func(t, y, slice)."""
    if method not in _STEPPERS:
        raise ValueError(f"Unknown method: {method}; expected one of {METHODS}")
    stepper = _STEPPERS[method]
    steps, starts, dt = _step_scalars(t)
    offsets = _STAGE_OFFSETS[method]
    if schedule_fn is None:
        func_s = lambda tt, y, sched: func(tt, y)  # noqa: E731
        scheds = (None,) * len(offsets)
    else:
        func_s = func
        scheds = tuple(schedule_fn(starts + off * dt) for off in offsets)  # float32 either way

    y = y0
    ys = [y0]
    for i, scalars in enumerate(steps):
        y = stepper(func_s, y, *scalars, [_slot(s, i) for s in scheds])
        if return_trajectory:
            ys.append(y)
    return torch.stack(ys) if return_trajectory else y[None]
