"""Adaptive loss-budget controller: per-client recovery escalation.

The paper's loss-tolerance claim holds below a loss fraction; above it,
staying with one_shot TRA biases the model toward well-connected
clients. This controller closes the loop inside the round step, as two
(N,) carries in ``EngineState``:

  * ``bud_loss``  — per-client EMA of the realized channel loss (the
    fraction of this round's packets the channel dropped, before any
    recovery), with coefficient ``ema``.
  * ``bud_level`` — the client's rung on the escalation ladder
    ``netsim/recovery.RECOVERY_POLICIES``: 0 = one_shot, 1 = fec,
    2 = arq.

Each round a cohort client's next-round policy goes up one level when
its loss EMA exceeds ``budget`` or its masked update norm diverges from
the cohort's (ssq > div_gate * median ssq), and down one below
``budget / 2`` (hysteresis). The policy applied in a round is the level
chosen after the previous observation: a client commits to a scheme
before the round's channel reveals itself.

``enabled`` is static (off, the controller is left out of the step);
``budget``, ``ema`` and ``div_gate`` are scenario knobs. The controller
needs ``RecoveryConfig(traced=True)``: mixing policies per client needs
all three recovery paths in the step. The expressions are the
reference's (``repro/core/lossbudget.py``) in float32, bitwise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.common import DENOM_EPS
from repro_torch.netsim.recovery import RECOVERY_POLICIES

N_LEVELS = len(RECOVERY_POLICIES)

# LossBudgetConfig fields a sweep scenario may vary
SWEEP_VARYING_BUD_FIELDS = ("budget", "ema", "div_gate")


@dataclasses.dataclass(frozen=True)
class LossBudgetConfig:
    enabled: bool = False   # static: builds the controller into the step
    budget: float = 0.2     # scenario knob: realized-loss EMA ceiling
    ema: float = 0.3        # scenario knob: EMA coefficient beta in (0, 1]
    div_gate: float = 16.0  # scenario knob: ssq > div_gate * median(ssq)
    #                         counts as update-norm divergence


def controller_policy_onehot(bud_level_c: torch.Tensor) -> torch.Tensor:
    """(C,) carried levels -> (C, N_LEVELS) f32 one-hot of the policy
    each cohort client committed to for this round."""
    lv = torch.clamp(torch.round(bud_level_c), 0.0, float(N_LEVELS - 1))
    levels = torch.arange(N_LEVELS, dtype=torch.float32,
                          device=bud_level_c.device)
    return (levels[None, :] == lv[:, None]).float()


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-d tensor: the mean of the two middle values
    for an even count, as (lo + hi) * 0.5 (``torch.median`` returns the
    lower one), and NaN if any value is NaN."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    mid = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(dim=-1), float("nan"), mid)


def controller_update(bud_level_c, bud_loss_c, realized_c, ssq, *,
                      budget, beta, div_gate):
    """One controller step for the cohort.

    bud_level_c / bud_loss_c: (C,) gathered carries; realized_c: (C,)
    this round's channel loss fraction (before recovery); ssq: (C,)
    masked squared update norms from the uplink pass; budget / beta /
    div_gate: scalars.

    Returns (new_level (C,), new_ema (C,), n_escalated ()).

    The EMA is one fused multiply-add, fma(1 - beta, ema, beta *
    realized), as XLA's CPU backend emits it in the reference's compiled
    step: the exact f32 product and the sum are taken in float64 and
    rounded once.
    """
    beta = torch.as_tensor(beta, dtype=torch.float32,
                           device=bud_loss_c.device)
    ema_new = ((1.0 - beta).double() * bud_loss_c.double()
               + (beta * realized_c).double()).float()
    med = median(ssq)
    diverged = ssq > div_gate * (med + DENOM_EPS)
    over = (ema_new > budget) | diverged
    under = (ema_new < 0.5 * budget) & ~diverged
    lv = torch.clamp(bud_level_c + over.float() - under.float(),
                     0.0, float(N_LEVELS - 1))
    n_escal = (lv > bud_level_c).float().sum()
    return lv, ema_new, n_escal
