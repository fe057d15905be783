"""AdamW and the learning-rate schedules of ``scripts/train.py``, as optax
computes them.

The JAX package trains with ``optax.adamw(lr)`` (its training/trainer.py
and scripts/train.py).  optax's defaults differ from PyTorch's AdamW, so
the port writes the update out:

- ``b1`` 0.9, ``b2`` 0.999, ``eps`` 1e-8 outside the square root,
  ``eps_root`` 0 inside it, and ``weight_decay`` 1e-4 (PyTorch: 1e-2),
  applied to every parameter (no mask: BatchNorm scales and biases, PReLU
  slopes and biases decay too);
- the update is ``mu_hat / (sqrt(nu_hat + eps_root) + eps) + wd * p``,
  scaled by ``-lr``; the bias corrections ``1 - b**t`` are taken in
  float32, as optax takes them;
- a schedule is read at the count BEFORE the step's increment, so the
  first step runs at ``lr(0)`` (0 under a warmup).

Schedules are plain ``count -> lr`` functions: :func:`warmup_constant`
(``optax.join_schedules`` of a linear warmup from 0 and a constant) and
:func:`warmup_cosine_decay` (``optax.warmup_cosine_decay_schedule(0, peak,
warmup, decay_steps)``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule(init, end, steps)``."""
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def warmup_constant(lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup from 0 over ``max(warmup_steps, 1)`` steps, then
    ``lr``: scripts/train.py's constant schedule with ``--warmup-steps``."""
    w = max(warmup_steps, 1)
    warm = _linear(0.0, lr, w)
    return lambda count: warm(count) if count < w else lr


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int,
                        end: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end)``: linear warmup to ``peak``, then a cosine decay to
    ``end`` over the remaining ``decay_steps - warmup_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps "
                         f"({decay_steps}) > warmup_steps ({warmup_steps})")
    warm = _linear(0.0, peak, warmup_steps)
    span = decay_steps - warmup_steps
    alpha = 0.0 if peak == 0.0 else end / peak

    def cosine(count: int) -> float:
        c = min(count, span)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span))
                       + alpha)

    return lambda count: (warm(count) if count < warmup_steps
                          else cosine(count - warmup_steps))


@dataclasses.dataclass
class AdamWState:
    """First and second moments by parameter name, and the step count."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` (module docstring); ``learning_rate`` a float or a
    schedule."""

    learning_rate: Union[float, Schedule] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        def zeros():
            return {n: torch.zeros_like(p) for n, p in params.items()}
        return AdamWState(zeros(), zeros(), 0)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             state: AdamWState) -> None:
        """One update of ``params`` (in place) from their ``.grad``."""
        names = list(params)
        ps = [params[n] for n in names]
        gs = [p.grad for p in ps]
        missing = [n for n, g in zip(names, gs) if g is None]
        if missing:
            raise ValueError(f"no gradient for {missing[:4]}")
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - self.b2)
        t = np.float32(state.count + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        den = torch._foreach_div(nu, bc2)
        if self.eps_root:
            torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.lr(state.count))
        torch._foreach_add_(ps, upd)
        state.count += 1


@dataclasses.dataclass
class SGDState:
    """The step count."""

    count: int = 0


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(learning_rate)``: ``p -= lr * g``, no momentum (the
    optimizer the parallel steps are held to the plain step with: Adam's
    sign-like update would magnify the last bits that a split sum
    moves)."""

    learning_rate: Union[float, Schedule] = 1e-2

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Dict[str, torch.Tensor]) -> SGDState:
        return SGDState()

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], state: SGDState) -> None:
        """One update of ``params`` (in place) from their ``.grad``."""
        ps = list(params.values())
        missing = [n for n, p in params.items() if p.grad is None]
        if missing:
            raise ValueError(f"no gradient for {missing[:4]}")
        # optax: updates = -lr * g, then p + updates
        torch._foreach_add_(ps, torch._foreach_mul(
            [p.grad for p in ps], -self.lr(state.count)))
        state.count += 1


__all__ = ["AdamW", "AdamWState", "SGD", "SGDState", "warmup_constant",
           "warmup_cosine_decay", "Schedule"]
