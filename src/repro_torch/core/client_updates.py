"""Client-side local training (thread Client of Algorithm 1).

Every function has the signature ``(params, X, Y, hyper) -> (upload,
aux)`` with X: (steps, bs, d), Y: (steps, bs) fixed-shape minibatches,
so the engine ``torch.func.vmap``s it across the cohort. This slice
ports FedAvg and q-FedAvg, the main path; the other algorithms wait for
their slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.func import grad

from repro_torch.core.mlp import Params, mlp_loss


def _sgd_steps(params: Params, X, Y, lr: float, loss_fn) -> Params:
    g_fn = grad(loss_fn)
    for s in range(X.shape[0]):
        g = g_fn(params, X[s], Y[s])
        params = {k: p - lr * g[k] for k, p in params.items()}
    return params


def fedavg_local(params: Params, X, Y, hyper) -> Tuple[Params, Dict]:
    """Local SGD; uploads the new model weights."""
    loss0 = mlp_loss(params, X.reshape(-1, X.shape[-1]), Y.reshape(-1))
    new = _sgd_steps(params, X, Y, hyper["lr"], mlp_loss)
    return new, {"loss0": loss0}


def qfedavg_local(params: Params, X, Y, hyper) -> Tuple[Params, Dict]:
    """q-FedAvg client (Li et al. 2019): F_k at w_t plus local SGD.
    Uploads dw_k = L_lip (w_t - w_k_new); the F_k^q reweighting is done
    by the server."""
    loss0 = mlp_loss(params, X.reshape(-1, X.shape[-1]), Y.reshape(-1))
    new = _sgd_steps(params, X, Y, hyper["lr"], mlp_loss)
    dw = {k: hyper["lipschitz"] * (params[k] - new[k]) for k in params}
    return dw, {"loss0": loss0}


def _not_ported(name):
    def local(*args, **kwargs):
        raise NotImplementedError(
            f"{name} local training is not ported to repro_torch yet")
    return local


LOCAL_FNS = {
    "fedavg": fedavg_local,
    "qfedavg": qfedavg_local,
    "afl": _not_ported("afl"),
    "pfedme": _not_ported("pfedme"),
    "perfedavg": _not_ported("perfedavg"),
    "scaffold": _not_ported("scaffold"),
}
