"""Finite-ness guards over trees of tensors.

The fault model (``netsim/faults.py``) makes non-finite values an
expected input, so a NaN that leaks past the defenses is a fault worth
failing fast on, with the offending leaf named, rather than a loss of
NaN twenty rounds later.

A tree is a tensor, or a dict or NamedTuple of trees (an
``EngineState``, a parameter dict); other leaves (None, Python numbers)
are skipped, as are integer and bool tensors, which cannot be
non-finite.

* ``all_finite_tree(tree)`` — a () bool tensor on the tree's device (its
  leaves share one), one reduction per float leaf and no host sync.
* ``assert_finite_tree(tree, name=...)`` — on the host: raises
  ``NonFiniteError`` naming the first offending leaf by its path (dict
  keys, NamedTuple field names), with its NaN and Inf counts.
"""
from __future__ import annotations

from typing import Any, Iterator, Tuple

import torch


class NonFiniteError(ValueError):
    """A tree leaf holds NaN or Inf (the message names the leaf path)."""


def _float_leaves(tree: Any, path: str = ""
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() or tree.is_complex():
            yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_leaves(v, f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _float_leaves(v, f"{path}/{k}")


def all_finite_tree(tree: Any) -> torch.Tensor:
    """() bool: every float leaf of ``tree`` is finite. An empty tree is
    finite."""
    bits = [torch.isfinite(leaf).all() for _, leaf in _float_leaves(tree)]
    if not bits:
        return torch.tensor(True)
    return torch.stack(bits).all()


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise ``NonFiniteError`` naming the first non-finite leaf of
    ``tree`` (``name`` then its path), with its NaN and Inf counts.
    Reads every float leaf on the host: call it between rounds."""
    for path, leaf in _float_leaves(tree):
        if bool(torch.isfinite(leaf).all()):
            continue
        n_nan = int(torch.isnan(leaf).sum())
        n_inf = int(torch.isinf(leaf).sum())
        raise NonFiniteError(
            f"{name}{path} ({leaf.dtype}, shape {tuple(leaf.shape)}) is "
            f"non-finite: {n_nan} NaN, {n_inf} Inf")
