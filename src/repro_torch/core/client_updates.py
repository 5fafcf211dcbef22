"""Client-side local training (thread Client of Algorithm 1).

Every function has the signature ``(params, X, Y, hyper) -> (upload,
aux)`` with X: (steps, bs, d), Y: (steps, bs) fixed-shape minibatches,
so the engine ``torch.func.vmap``s it across the cohort; SCAFFOLD's
client also takes the server and client control variates. The six
algorithms of the reference are here: FedAvg, q-FedAvg, AFL (FedAvg's
client), pFedMe, Per-FedAvg and SCAFFOLD, with the personalization
steps that pFedMe and Per-FedAvg evaluate. The reference's
``lax.scan`` loops are Python loops over the same steps.
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


def _loss0(params: Params, X, Y) -> torch.Tensor:
    """The loss at the start of local training, over all the batches."""
    return mlp_loss(params, X.reshape(-1, X.shape[-1]), Y.reshape(-1))


def fedavg_local(params: Params, X, Y, hyper) -> Tuple[Params, Dict]:
    """Local SGD; uploads the new model weights."""
    loss0 = _loss0(params, X, Y)
    new = _sgd_steps(params, X, Y, hyper["lr"], mlp_loss)
    return new, {"loss0": loss0}


def qfedavg_local(params: Params, X, Y, hyper) -> Tuple[Params, Dict]:
    """q-FedAvg client (Li et al. 2019): F_k at w_t plus local SGD.
    Uploads dw_k = L_lip (w_t - w_k_new); the F_k^q reweighting is done
    by the server."""
    loss0 = _loss0(params, X, Y)
    new = _sgd_steps(params, X, Y, hyper["lr"], mlp_loss)
    dw = {k: hyper["lipschitz"] * (params[k] - new[k]) for k in params}
    return dw, {"loss0": loss0}


def _prox_loss(lam: float, anchor: Params):
    """f(theta; x, y) + lam/2 ||theta - anchor||^2, the squared distance
    summed leaf by leaf in the reference's leaf order (b1, b2, w1, w2)."""
    def loss(theta: Params, x, y):
        sq = sum(torch.sum(torch.square(theta[k] - anchor[k]))
                 for k in theta)
        return mlp_loss(theta, x, y) + 0.5 * lam * sq
    return loss


def pfedme_local(params: Params, X, Y, hyper) -> Tuple[Params, Dict]:
    """pFedMe client (Dinh et al. 2020): Moreau-envelope local rounds.

    X is consumed as R = steps // K rounds of K steps (the tail is
    dropped). Each round solves min_theta f(theta; batch) + lam/2
    ||theta - w||^2 with K SGD steps, then w <- w - eta lam (w - theta).
    Uploads the local w."""
    lam, K, eta, lr = hyper["lam"], hyper["K"], hyper["eta"], hyper["lr"]
    loss0 = _loss0(params, X, Y)
    w = params
    for r in range(X.shape[0] // K):
        theta = _sgd_steps(w, X[r * K:(r + 1) * K], Y[r * K:(r + 1) * K],
                           lr, _prox_loss(lam, w))
        w = {k: w[k] - eta * lam * (w[k] - theta[k]) for k in w}
    return w, {"loss0": loss0}


def pfedme_personalize(params: Params, X, Y, hyper) -> Params:
    """theta_i(w): K proximal steps from the global model, the
    personalized model of pFedMe's 'P' evaluation."""
    return _sgd_steps(params, X, Y, hyper["lr"],
                      _prox_loss(hyper["lam"], params))


def perfedavg_local(params: Params, X, Y, hyper) -> Tuple[Params, Dict]:
    """Per-FedAvg client (Fallah et al. 2020), first-order MAML over
    consecutive pairs of batches: w' = w - a grad f(w, b1), then
    w <- w - b grad f(w', b2)."""
    a, b = hyper["alpha"], hyper["beta_maml"]
    loss0 = _loss0(params, X, Y)
    g_fn = grad(mlp_loss)
    w = params
    for s in range(X.shape[0] // 2):
        g1 = g_fn(w, X[2 * s], Y[2 * s])
        w_in = {k: w[k] - a * g1[k] for k in w}
        g2 = g_fn(w_in, X[2 * s + 1], Y[2 * s + 1])
        w = {k: w[k] - b * g2[k] for k in w}
    return w, {"loss0": loss0}


def perfedavg_personalize(params: Params, X, Y, hyper) -> Params:
    """One-step adaptation at evaluation time (the MAML test-time
    update), one gradient over all the batches."""
    g = grad(mlp_loss)(params, X.reshape(-1, X.shape[-1]), Y.reshape(-1))
    return {k: p - hyper["alpha"] * g[k] for k, p in params.items()}


def scaffold_local(params: Params, X, Y, c_global: Params, c_i: Params,
                   hyper) -> Tuple[Dict[str, Params], Dict]:
    """SCAFFOLD client (Karimireddy et al. 2020, option II).

    Local SGD on the variance-reduced gradient g + c - c_i; uploads
    dw = w+ - w (the opposite sign to q-FedAvg's) and dc = c_i+ - c_i
    with c_i+ = c_i - c + (w - w+) / (K lr), K = the local steps."""
    lr = hyper["lr"]
    K = X.shape[0]
    loss0 = _loss0(params, X, Y)
    g_fn = grad(mlp_loss)
    new = params
    for s in range(K):
        g = g_fn(new, X[s], Y[s])
        new = {k: new[k] - lr * (g[k] + c_global[k] - c_i[k]) for k in new}
    dw = {k: new[k] - params[k] for k in params}
    ci_new = {k: c_i[k] - c_global[k] + (params[k] - new[k]) / (K * lr)
              for k in params}
    dc = {k: ci_new[k] - c_i[k] for k in params}
    return {"dw": dw, "dc": dc}, {"loss0": loss0}


# SCAFFOLD's client takes the control variates too; the engine calls
# ``scaffold_local`` itself, as the reference's does
LOCAL_FNS = {
    "fedavg": fedavg_local,
    "qfedavg": qfedavg_local,
    "afl": fedavg_local,
    "pfedme": pfedme_local,
    "perfedavg": perfedavg_local,
}

PERSONALIZE_FNS = {
    "pfedme": pfedme_personalize,
    "perfedavg": perfedavg_personalize,
}
