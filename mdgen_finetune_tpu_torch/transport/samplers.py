"""ODE and SDE integrators of the samplers, and the likelihood ODE.

Counterpart of the JAX package's ``transport/samplers.py`` (reference
src/mdgen/transport/integrators.py and Sampler,
src/mdgen/transport/transport.py:278-510) with the same arithmetic:

- euler / heun: fixed steps on the grid t0 + dt * i (f32);
- dopri5: adaptive Dormand-Prince 5(4) with JAX's tableau (``_DP_*``), FSAL,
  the first step h0 = 0.01 * (t1 - t0), the RMS error norm against
  atol + rtol * max(|y0|, |y1|), the step factor
  clip(0.9 * (err + 1e-10)^-0.2, 0.2, 5) and at most ``max_steps`` attempts,
  rejected ones included (torchdiffeq's defaults atol 1e-6, rtol 1e-3);
- ``sample_sde``: Euler-Maruyama or Heun on the reverse SDE, then a last
  ``Mean`` or ``Euler`` step (JAX :192-256);
- ``ode_likelihood``: the reversed probability-flow ODE with a Hutchinson
  divergence from a reverse-mode VJP through the drift (JAX :150-189).

JAX runs these inside ``lax.scan`` / ``lax.while_loop``; here they are host
loops. dopri5 keeps t and h as f32 scalars on the host and reads the error
norm back once per attempt, for the accept test: one host sync per attempt.

Every integrator takes ``drift(x, t_vec)`` with t_vec (B,) and the samplers
return (x_final, counts) with counts {"accepted", "rejected", "evals"}:
steps taken, steps refused, drift evaluations. The Gaussian noise of the SDE
and the Rademacher probes of the likelihood come from a ``torch.Generator``
or are passed in whole, (num_steps, *x.shape), so that a caller can hand
two implementations the same draws.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .paths import expand_t

_F32 = torch.float32


def _tvec(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A host f32 scalar as the (B,) time vector on x's device (a fill, not
    a copy: no wait for the device)."""
    return torch.full((x.shape[0],), float(t), dtype=x.dtype, device=x.device)


def _grid(t0: float, t1: float, num_steps: int):
    dt = (t1 - t0) / num_steps
    return dt, t0 + dt * torch.arange(num_steps, dtype=_F32)


def ode_euler(drift: Callable, x: torch.Tensor, t0: float, t1: float, num_steps: int):
    dt, ts = _grid(t0, t1, num_steps)
    for t in ts:
        x = x + drift(x, _tvec(t, x)) * dt
    return x, {"accepted": num_steps, "rejected": 0, "evals": num_steps}


def ode_heun(drift: Callable, x: torch.Tensor, t0: float, t1: float, num_steps: int):
    dt, ts = _grid(t0, t1, num_steps)
    for t in ts:
        k1 = drift(x, _tvec(t, x))
        k2 = drift(x + dt * k1, _tvec(t + dt, x))
        x = x + dt * 0.5 * (k1 + k2)
    return x, {"accepted": num_steps, "rejected": 0, "evals": 2 * num_steps}


# Dormand-Prince 5(4) tableau (mdgen_finetune_tpu/transport/samplers.py:59-72)
_DP_C = torch.tensor([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], dtype=_F32)
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DP_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]


def ode_dopri5(drift: Callable, x: torch.Tensor, t0: float, t1: float, atol: float = 1e-6,
               rtol: float = 1e-3, max_steps: int = 1000, mean: Optional[Callable] = None):
    """Adaptive RK45 from t0 to t1 (module docstring); ``mean`` takes the
    error norm's mean (default ``torch.mean``; a sharded batch passes the
    mean over every rank's rows, so that all take the same steps)."""
    mean = mean or torch.mean
    b5 = torch.tensor(_DP_B5, dtype=x.dtype, device=x.device)
    b4 = torch.tensor(_DP_B4, dtype=x.dtype, device=x.device)
    t0 = torch.tensor(t0, dtype=_F32)
    t1 = torch.tensor(t1, dtype=_F32)

    def err_norm(err, y0, y1):
        scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
        return torch.sqrt(mean((err / scale) ** 2))

    f = drift(x, _tvec(t0, x))
    h = torch.tensor(0.01, dtype=_F32) * (t1 - t0)
    t, y, n = t0, x, 0
    counts = {"accepted": 0, "rejected": 0, "evals": 1}
    while bool(t < t1) and n < max_steps:
        h = torch.minimum(h, t1 - t)
        ks = [f]
        for i in range(1, 7):
            yi = y
            for j, a in enumerate(_DP_A[i]):
                yi = yi + h * a * ks[j]
            ks.append(drift(yi, _tvec(t + _DP_C[i] * h, y)))
        counts["evals"] += 6
        k = torch.stack(ks)
        y5 = y + h * torch.tensordot(b5, k, dims=1)
        y4 = y + h * torch.tensordot(b4, k, dims=1)
        err = err_norm(y5 - y4, y, y5).to("cpu", _F32)  # the attempt's one sync
        factor = torch.clamp(0.9 * (err + 1e-10) ** (-0.2), 0.2, 5.0)
        if bool(err <= 1.0):
            t, y, f = t + h, y5, ks[6]  # FSAL
            counts["accepted"] += 1
        else:
            counts["rejected"] += 1
        h = h * factor
        n += 1
    return y, counts


def sample_ode(drift: Callable, x: torch.Tensor, *, t0: float = 0.0, t1: float = 1.0,
               method: str = "dopri5", num_steps: int = 100, atol: float = 1e-6,
               rtol: float = 1e-3, mean: Optional[Callable] = None):
    """Integrate ``drift`` from t0 to t1 with ``method``; returns
    (x_final, counts) (module docstring; ``mean``: ``ode_dopri5``'s)."""
    if method == "euler":
        return ode_euler(drift, x, t0, t1, num_steps)
    if method == "heun":
        return ode_heun(drift, x, t0, t1, num_steps)
    if method == "dopri5":
        return ode_dopri5(drift, x, t0, t1, atol=atol, rtol=rtol, mean=mean)
    raise NotImplementedError(method)


def _draw(generator: torch.Generator, x: torch.Tensor, rademacher: bool = False,
          rows: Optional[tuple] = None):
    """One standard normal (or +-1) draw of x's shape from ``generator``, on
    x's device; ``rows`` (slice, B): x holds those rows of a batch of B,
    and the draw is the batch's, sliced."""
    shape = x.shape if rows is None else (rows[1], *x.shape[1:])
    if rademacher:
        e = torch.randint(0, 2, shape, generator=generator, device=generator.device)
        e = e.to(x.dtype) * 2 - 1
    else:
        e = torch.randn(shape, generator=generator, device=generator.device, dtype=x.dtype)
    return (e if rows is None else e[rows[0]]).to(x.device)


def ode_likelihood(drift: Callable, x: torch.Tensor, *, t0: float = 0.0, t1: float = 1.0,
                   num_steps: int = 100, generator: Optional[torch.Generator] = None,
                   probes: Optional[torch.Tensor] = None):
    """Integrate the reversed probability-flow ODE from x with a running
    Hutchinson divergence (JAX :150-189; reference
    src/mdgen/transport/transport.py:452-510): returns (x0, delta_logp (B,)),
    log p(x) = prior_logp(x0) - delta_logp.

    On the grid t0 + dt * i the drift is taken at 1 - t; each step draws one
    Rademacher probe eps (``probes[i]``, else from ``generator``), takes
    eps^T J by a reverse-mode VJP of the drift with respect to x
    (``torch.autograd.grad``: the trunk's hand-written backward has no
    forward-mode rule), adds (eps . eps^T J) dt over every non-batch axis to
    delta_logp and moves x to x - f dt. A drift that does not depend on x
    raises in the VJP: the divergence is never taken as zero."""
    dt = (t1 - t0) / num_steps
    _, ts = _grid(t0, t1, num_steps)
    dims = tuple(range(1, x.ndim))
    logp = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, t in enumerate(ts):
        eps = probes[i].to(x.device, x.dtype) if probes is not None else _draw(
            generator, x, rademacher=True)
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            f = drift(xg, _tvec(1.0 - t, x))
            (eps_j,) = torch.autograd.grad(f, xg, eps)
        logp = logp + (eps_j * eps).sum(dims) * dt
        x = x - f.detach() * dt
    return x, logp


def sample_sde(drift: Callable, diffusion: Callable, score: Callable, x: torch.Tensor, *,
               t0: float, t1: float, num_steps: int = 250, method: str = "Euler",
               last_step: Optional[str] = "Mean", last_step_size: float = 0.04,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, rows: Optional[tuple] = None):
    """Euler-Maruyama (``Euler``) or Heun SDE sampler (JAX :192-256; reference
    src/mdgen/transport/transport.py:294-405, integrators.py:26-45).

    ``drift(x, t)`` is the probability-flow drift and ``score(x, t)`` the
    score, t (B,); ``diffusion(x, te)`` takes t expanded against x. The SDE
    drift is drift + diffusion * score. On the grid t0 + dt * i each step
    takes w = noise[i] * sqrt(|dt|) (``noise`` (num_steps, *x.shape)
    standard normals, else drawn from ``generator`` step by step, for the
    whole batch of a sharded one when ``rows`` = (slice, B) is given):
    Euler-Maruyama x + sde_drift dt + sqrt(2 diff) w; Heun perturbs first,
    xhat = x + sqrt(2 diff) w, then averages the SDE drift at xhat (t) and at
    xhat + dt k1 (t + dt). Then one last step of ``last_step_size`` at t1:
    ``Mean`` with the SDE drift, ``Euler`` with the drift alone, None
    (the transport's Tweedie step follows) none. Returns (x, counts)."""
    dt = (t1 - t0) / num_steps
    _, ts = _grid(t0, t1, num_steps)
    sq_dt = math.sqrt(abs(dt))
    evals = 0

    def sde_drift(xc, tv):
        return drift(xc, tv) + diffusion(xc, expand_t(tv, xc)) * score(xc, tv)

    for i, t in enumerate(ts):
        tv = _tvec(t, x)
        z = noise[i].to(x.device, x.dtype) if noise is not None else _draw(generator, x,
                                                                           rows=rows)
        w = z * sq_dt
        root = torch.sqrt(2 * diffusion(x, expand_t(tv, x)))
        if method == "Euler":
            x = x + sde_drift(x, tv) * dt + root * w
            evals += 1
        elif method == "Heun":
            xhat = x + root * w
            k1 = sde_drift(xhat, tv)
            k2 = sde_drift(xhat + dt * k1, _tvec(t + dt, x))
            x = xhat + 0.5 * dt * (k1 + k2)
            evals += 2
        else:
            raise NotImplementedError(method)
    t_last = _tvec(t1, x)
    if last_step == "Mean":
        x = x + sde_drift(x, t_last) * last_step_size
        evals += 1
    elif last_step == "Euler":
        x = x + drift(x, t_last) * last_step_size
        evals += 1
    elif last_step is not None:
        raise NotImplementedError(last_step)
    return x, {"accepted": num_steps, "rejected": 0, "evals": evals}
