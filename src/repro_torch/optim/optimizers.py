"""Optimizers on trees of tensors: SGD (+momentum), AdamW, global-norm
clipping and the cosine schedule (the reference's
``repro/optim/optimizers.py``).

These are plain functions on dicts of tensors, not ``torch.optim``
classes: the state is a tree in the reference's layout (SGD's momentum
tree or ``()``; AdamW's ``{"mu", "nu", "count"}``), so a step's state
converts both ways (``convert.opt_state_from_jax``). A tree's leaves are
walked in sorted-key order, ``jax.tree_util``'s, so sums over leaves
add in the reference's order.

``Optimizer.update`` is functional, as the reference's. ``update_`` is
the same arithmetic, leaf by leaf, written into the given parameter and
state tensors: what ``jax.jit(..., donate_argnums=...)`` lets XLA do
with buffers. A full-width AdamW step on one card needs it (old and new
moments side by side do not fit).
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch


# ---------------------------------------------------------------------------
# trees: nested dicts of tensors, walked in sorted-key order
# ---------------------------------------------------------------------------
def tree_paths(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict in ``jax.tree_util`` order:
    keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in sorted-key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in sorted-key order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    # in place: (grads, state, params) -> (params, state), the tensors
    # of ``params`` and ``state`` overwritten with the new values
    update_: Callable[[Any, Any, Any], Tuple[Any, Any]]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves
    added in order from 0."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to global norm at most ``max_norm``, the norm). Each
    leaf keeps its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale.to(g.dtype)).to(g.dtype),
                    tree), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: _apply(p, u), params, updates)


def _apply(p, u):
    return (p.float() + u).to(p.dtype)


def _in_place(leaf_step, grads, params, states):
    """Run ``leaf_step(g, p, *s) -> (u, *new_s)`` over the leaves and
    write the new parameter and states into ``params`` / ``states``."""
    g_leaves = tree_leaves(grads)
    p_leaves = tree_leaves(params)
    s_leaves = [tree_leaves(s) for s in states]
    for i, (g, p) in enumerate(zip(g_leaves, p_leaves)):
        old = [s[i] for s in s_leaves]
        u, *new = leaf_step(g, p, *old)
        with torch.no_grad():
            p.copy_(_apply(p, u))
            for o, n in zip(old, new):
                o.copy_(n)
        del u, new


def _weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak type: rounded to ``like``'s dtype
    before the arithmetic (torch would keep it in f32 for a bf16 leaf)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def leaf(g, p, m=None):
        if momentum == 0.0:
            return (_weak(-lr, g) * g,)
        m = momentum * m + g.float()
        return -lr * m, m

    def update(grads, state, params):
        if momentum == 0.0:
            return tree_map(lambda g, p: leaf(g, p)[0], grads, params), state
        out = tree_map(leaf, grads, params, state)
        return _pick(out, 0), _pick(out, 1)

    def update_(grads, state, params):
        _in_place(leaf, grads, params, () if momentum == 0.0 else (state,))
        return params, state

    return Optimizer(init, update, update_)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"mu": tree_map(z, params), "nu": tree_map(z, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    def corrections(count):
        c = count + 1
        cf = c.float()
        return c, 1 - b1 ** cf, 1 - b2 ** cf

    def leaf(g, p, m, v, bc1, bc2):
        gf = g.float()
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf.square()
        u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                   + weight_decay * p.float())
        return u, m, v

    def update(grads, state, params):
        c, bc1, bc2 = corrections(state["count"])
        out = tree_map(lambda g, p, m, v: leaf(g, p, m, v, bc1, bc2),
                       grads, params, state["mu"], state["nu"])
        return _pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2),
                               "count": c}

    def update_(grads, state, params):
        c, bc1, bc2 = corrections(state["count"])
        _in_place(lambda g, p, m, v: leaf(g, p, m, v, bc1, bc2), grads,
                  params, (state["mu"], state["nu"]))
        state["count"].copy_(c)
        return params, state

    return Optimizer(init, update, update_)


def _pick(tree_of_tuples, i):
    """The tree of the ``i``-th entries of a tree of tuples."""
    if isinstance(tree_of_tuples, dict):
        return {k: _pick(v, i) for k, v in tree_of_tuples.items()}
    return tree_of_tuples[i]


def make_optimizer(name: str, lr: float, *, momentum=0.9,
                   weight_decay=0.0) -> Optimizer:
    if name == "sgd":
        return sgd(lr, momentum)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    raise ValueError(name)


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    """lr(step): linear warmup to ``base_lr``, then a half cosine to 0 at
    ``total`` (f32, as the reference's)."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "make_optimizer", "sgd",
           "tree_leaves", "tree_map", "tree_paths", "tree_unflatten"]
