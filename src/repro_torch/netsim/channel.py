"""Gilbert–Elliott two-state Markov loss channel.

Each client carries a hidden state s in {GOOD=0, BAD=1} with
per-packet transition probabilities and per-state loss (emission)
probabilities:

    GOOD --p_gb--> BAD        loss | GOOD ~ Bernoulli(h_g)
    BAD  --p_bg--> GOOD       loss | BAD  ~ Bernoulli(h_b)

The user-facing knobs are the stationary loss rate r (the same
``loss_rate`` the i.i.d. channel uses) and the expected BAD-sojourn
length L in packets:

    pi_b = (r - h_g) / (h_b - h_g)     stationary BAD fraction
    p_bg = 1 / L
    p_gb = p_bg * pi_b / (1 - pi_b)    detailed balance

The per-packet recurrence (transition first, then emission) runs in
``kernels/netsim_mask``; this module holds the parameter math, the
stationary initial state and a host-side numpy sampler. Every
expression is the reference's (``repro/netsim/channel.py``) in float32,
so the results are bitwise the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.common import RATE_EPS

# fold_in tag of the stationary channel-state draw: far outside the
# round-index range, so it never collides with a round key
CH_INIT_FOLD = 0x4E455453  # "NETS"
# fold_in tag of the downlink chain's stationary state draw
DOWN_INIT_FOLD = 0x444F574E  # "DOWN"


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def stationary_bad_frac(loss_rate, good_loss, bad_loss) -> torch.Tensor:
    """pi_b such that pi_g*h_g + pi_b*h_b == loss_rate, clipped to a
    proper probability."""
    loss_rate, good_loss, bad_loss = (_f32(v) for v in
                                      (loss_rate, good_loss, bad_loss))
    pi_b = (loss_rate - good_loss) \
        / torch.clamp(bad_loss - good_loss, min=RATE_EPS)
    return torch.clamp(pi_b, 0.0, 1.0 - RATE_EPS)


def ge_transition_probs(loss_rate, burst_len, good_loss, bad_loss):
    """(p_gb, p_bg) hitting the stationary rate and the burst length.
    Arguments may be scalars or (C,) per-client tensors."""
    pi_b = stationary_bad_frac(loss_rate, good_loss, bad_loss)
    p_bg = 1.0 / torch.clamp(_f32(burst_len), min=1.0)
    p_gb = torch.clamp(p_bg * pi_b / torch.clamp(1.0 - pi_b, min=RATE_EPS),
                       0.0, 1.0)
    return p_gb, p_bg


def init_channel_state(base_key: torch.Tensor, n_clients: int, loss_rate,
                       good_loss, bad_loss) -> torch.Tensor:
    """(N,) int32 stationary draw of the clients' channel states, from
    ``fold_in(base_key, CH_INIT_FOLD)``: the single engine and the
    sweep (same per-scenario base key) start from the same states."""
    pi_b = stationary_bad_frac(loss_rate, good_loss, bad_loss)
    u = prng.uniform(prng.fold_in(base_key, CH_INIT_FOLD), (n_clients,))
    return (u < pi_b.to(u.device)).to(torch.int32)


def sample_ge_mask_numpy(rng: np.random.Generator, n_clients: int,
                         n_pkts: int, loss_rate: float, burst_len: float,
                         good_loss: float = 0.0, bad_loss: float = 1.0
                         ) -> np.ndarray:
    """Host-side sampler (the loop a simulator without a device would
    run): (C, P) delivery mask, 1 = delivered. Not the parity oracle,
    which is ``kernels/netsim_mask/ref.py`` on the engine's uniforms."""
    pi_b = np.clip((loss_rate - good_loss)
                   / max(bad_loss - good_loss, RATE_EPS), 0.0, 1.0)
    p_bg = 1.0 / max(burst_len, 1.0)
    p_gb = min(p_bg * pi_b / max(1.0 - pi_b, RATE_EPS), 1.0)
    mask = np.ones((n_clients, n_pkts), np.float32)
    s = (rng.random(n_clients) < pi_b).astype(np.int32)
    for p in range(n_pkts):
        flip = rng.random(n_clients) < np.where(s == 1, p_bg, p_gb)
        s = np.where(flip, 1 - s, s)
        h = np.where(s == 1, bad_loss, good_loss)
        mask[:, p] = (rng.random(n_clients) >= h).astype(np.float32)
    return mask
