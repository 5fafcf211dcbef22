"""Client selection by weighted Gumbel-top-k (paper §5, the bias axis).

Threshold-based selection biases the cohort toward well-connected
clients; TRA lets the server select regardless of the network. Both
sides, and the gradient- and loss-aware policies of the related work,
are one score-based family:

    ids = top_k( where(eligible, gumbel + logits, -inf), k )

Adding i.i.d. Gumbel noise to the logits and taking the top k samples
without replacement, with weights softmax(logits). ``logits = None``
is the ``uniform`` policy and skips the add, so the sampler is bitwise
the uniform Gumbel-top-k of the earlier slices.

Policies (``SelectionConfig.policy``) and their per-client scores:

    uniform              no score
    bandwidth_threshold  s_i = 1[bw_i >= threshold_mbps], from the
                         static trace draw or, with ``bw_ar1``, the live
                         AR(1) ``NetSimState.logbw``
    gradient_norm        s_i = log1p(|Δ_i|²), the masked squared update
                         norm the uplink kernel returns, carried in
                         ``EngineState.gnorm_mem``
    loss_aware           s_i = the client's last train loss
                         (``EngineState.loss_mem``)
    netsim_state         s_i = 1[channel_i == GOOD] (Gilbert–Elliott)
    staleness_aware      s_i = -log1p(lateness_i), the rounds late the
                         deadline last observed (``EngineState.stale_mem``)
    reputation_aware     s_i = -log1p(reputation_i), the cumulative
                         quarantined-packet fraction (``EngineState.rep_mem``;
                         needs the fault model)
    recovery_pressure    s_i = log1p(level_i + ema_i), the loss-budget
                         controller's carries (needs the controller)

``policy`` and ``traced`` are static: they shape the round step. The
threshold, temperature and exploration ride ``ScenarioCtx`` and may
vary across a sweep; with ``traced=True`` so does the policy, as the
one-hot ``ScenarioCtx.sel_policy`` that ``traced_policy_logits``
contracts every policy's score with, so a policy x loss-rate grid is
one batched step a round. The logits of every policy but ``uniform``:

    logits_i = (1 - explore) * s_i / max(temperature, TEMP_EPS)

A score whose source is absent from the configuration (for example the
reputation without the fault model, in traced mode) is zeros, i.e. that
policy samples uniformly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.network.trace import DEFAULT_THRESHOLD_MBPS

POLICIES = ("uniform", "bandwidth_threshold", "gradient_norm",
            "loss_aware", "netsim_state", "staleness_aware",
            "reputation_aware", "recovery_pressure")

# temperature guard: temperature 0 means as sharp as f32 allows, not NaN
TEMP_EPS = 1e-6

# the lowest finite float64: the sort key of an ineligible client once
# NaN keys take -inf (``select_from_uniforms``)
_BELOW_F32 = float(np.finfo(np.float64).min)


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    """Selection-policy knobs: ``policy`` and ``traced`` are static,
    the rest (``SWEEP_VARYING_SEL_FIELDS``) are scenario knobs."""
    policy: str = "uniform"     # one of POLICIES
    # every policy's score built in; the policy becomes a scenario knob
    traced: bool = False
    threshold_mbps: float = DEFAULT_THRESHOLD_MBPS  # bandwidth_threshold
    temperature: float = 1.0    # softmax temperature on the raw score
    explore: float = 0.0        # 0 = pure policy, 1 = uniform

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown selection policy {self.policy!r}")


# SelectionConfig fields a scenario may vary without changing the step
# (and the policy itself when ``traced``)
SWEEP_VARYING_SEL_FIELDS = ("threshold_mbps", "temperature", "explore")


def policy_onehot(policy: str) -> np.ndarray:
    """(len(POLICIES),) f32 one-hot for ``ScenarioCtx.sel_policy``."""
    v = np.zeros(len(POLICIES), np.float32)
    v[POLICIES.index(policy)] = 1.0
    return v


def select_from_uniforms(u: torch.Tensor, logits, eligible: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Weighted Gumbel-top-k from pre-drawn uniforms ``u`` (N,).

    Ineligible clients score -inf and are picked only once the eligible
    set is exhausted. A stable descending sort breaks ties lowest index
    first, as the reference's ``top_k`` does. ``logits = None`` is the
    uniform policy and evaluates the uniform expression alone.

    With logits, a key may be NaN (a client whose upload failed leaves a
    NaN norm). ``top_k`` ranks floats by their total order, in which the
    NaN the reference's arithmetic produces (sign bit set) lies below
    -inf: such a client is picked last, after the ineligible ones. The
    keys are sorted in float64, where that order holds whatever the
    NaN's sign: NaN at -inf, -inf at the lowest finite float64, every
    float32 key exactly.
    """
    gumbel = -torch.log(-torch.log(u))
    if logits is None:
        keys = torch.where(eligible, gumbel, float("-inf"))
        return torch.sort(keys, descending=True, stable=True).indices[:k]
    keys = torch.where(eligible, gumbel + logits, float("-inf")).double()
    keys = torch.where(torch.isnan(keys), float("-inf"),
                       torch.where(keys == float("-inf"), _BELOW_F32, keys))
    return torch.sort(keys, descending=True, stable=True).indices[:k]


def select_clients(key: torch.Tensor, scores, eligible: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Sample ``k`` clients without replacement, with weights
    softmax(scores) over the eligible set (None: uniform), from one
    uniform draw of ``key``. The engine slices its round's uniform
    block instead."""
    u = prng.uniform(key, tuple(eligible.shape), minval=1e-12, maxval=1.0)
    return select_from_uniforms(u, scores, eligible, k)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A scenario knob as an f32 tensor (the engine passes tensors)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _absent(t) -> bool:
    return t is None or t.shape[-1] == 0


def raw_policy_score(policy: str, *, threshold_mbps=None, logbw=None,
                     gnorm_mem=None, loss_mem=None, channel=None,
                     stale_mem=None, rep_mem=None, bud_level=None,
                     bud_loss=None):
    """(N,) raw score s_i of one policy; None for ``uniform`` and for a
    policy whose score source is absent (None or zero-size)."""
    if policy == "uniform":
        return None
    if policy == "bandwidth_threshold":
        if _absent(logbw):
            return None
        thr = torch.log(torch.clamp(_f32(threshold_mbps, logbw),
                                    min=TEMP_EPS))
        return (logbw >= thr).to(torch.float32)
    if policy == "gradient_norm":
        # log1p keeps a never-selected client (norm 0) at score 0
        return None if _absent(gnorm_mem) else torch.log1p(gnorm_mem)
    if policy == "loss_aware":
        return None if _absent(loss_mem) else loss_mem
    if policy == "netsim_state":
        if _absent(channel):
            return None
        return 1.0 - channel.to(torch.float32)
    if policy == "staleness_aware":
        # never late scores 0; the MAX_LATENESS sentinel about -14
        return None if _absent(stale_mem) else -torch.log1p(stale_mem)
    if policy == "reputation_aware":
        # never quarantined scores 0; repeat offenders sink smoothly
        return None if _absent(rep_mem) else -torch.log1p(rep_mem)
    if policy == "recovery_pressure":
        if _absent(bud_level):
            return None
        # escalated clients are preferred: their uploads are recoverable
        ema = torch.zeros_like(bud_level) if _absent(bud_loss) else bud_loss
        return torch.log1p(bud_level + ema)
    raise ValueError(f"unknown selection policy {policy!r}")


def _scale(raw, temperature, explore):
    return (1.0 - _f32(explore, raw)) * raw \
        / torch.clamp(_f32(temperature, raw), min=TEMP_EPS)


def policy_logits(policy: str, *, temperature, explore, threshold_mbps=None,
                  logbw=None, gnorm_mem=None, loss_mem=None, channel=None,
                  stale_mem=None, rep_mem=None, bud_level=None,
                  bud_loss=None):
    """The Gumbel-top-k logits of one static policy (None: uniform
    sampling, the uniform expression)."""
    s = raw_policy_score(policy, threshold_mbps=threshold_mbps, logbw=logbw,
                         gnorm_mem=gnorm_mem, loss_mem=loss_mem,
                         channel=channel, stale_mem=stale_mem,
                         rep_mem=rep_mem, bud_level=bud_level,
                         bud_loss=bud_loss)
    return None if s is None else _scale(s, temperature, explore)


def traced_policy_logits(sel_policy, *, temperature, explore,
                         threshold_mbps, logbw=None, gnorm_mem=None,
                         loss_mem=None, channel=None, stale_mem=None,
                         rep_mem=None, bud_level=None, bud_loss=None,
                         n_clients=None):
    """The logits with the policy itself a scenario knob: every policy's
    raw score, contracted with the (len(POLICIES),) one-hot
    ``sel_policy``. The contraction is an elementwise product and a sum,
    never a matmul (which the card may run in TF32): with an exact
    one-hot every other term is 0 (or -0), so in any summation order
    finite scores give the chosen policy's bits, as the reference's
    ``einsum`` does."""
    rows = []
    for p in POLICIES:
        s = raw_policy_score(p, threshold_mbps=threshold_mbps, logbw=logbw,
                             gnorm_mem=gnorm_mem, loss_mem=loss_mem,
                             channel=channel, stale_mem=stale_mem,
                             rep_mem=rep_mem, bud_level=bud_level,
                             bud_loss=bud_loss)
        rows.append(torch.zeros((n_clients,), dtype=torch.float32,
                                device=sel_policy.device)
                    if s is None else s)
    raw = (sel_policy[:, None] * torch.stack(rows)).sum(0)
    return _scale(raw, temperature, explore)
