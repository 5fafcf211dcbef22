"""Logical-axis sharding context (the reference's
``repro/utils/shardctx.py``), as single-device no-ops.

Model code annotates activations with logical axis names via
:func:`shard`; a launcher installs a mapping from logical names to mesh
axes with :func:`use_rules`. The port runs on one device, so ``shard``
checks the annotation's rank and returns its input: the mesh, the
rules' translation and the constraints come with distribution (ROADMAP
Queue 1 item 8.4). Until then the forward annotates only the block
stack's input; the reference's per-layer annotations (attention's q and
output, the cross-entropy's logits) come back with that item.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None), getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(mesh, rules: dict):
    """rules: logical-name -> mesh axis (str | tuple | None)."""
    old = current_rules()
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = old


def shard(x, *names: Optional[str]):
    """Annotate ``x`` with logical axis names (one per dim; None =
    replicated). Outside a rules context, or on one device, ``x``
    itself; inside one, a rank that does not match the names raises, as
    the reference's does."""
    rules, mesh = current_rules()
    if rules is None or mesh is None:
        return x
    if x.dim() != len(names):
        raise ValueError(f"shard(): rank {x.dim()} != {len(names)} names "
                         f"{names}")
    return x
