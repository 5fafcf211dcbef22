"""Division-guard epsilons shared by the port's kernels, their plain
versions and the engine: the single source, so a kernel and its plain
version can never drift apart on a guard. Also the scenario-axis fold
that the row-wise kernels' vmap rules share, and the scenario chunks of
the kernels whose scenarios lie on grid.y."""
from __future__ import annotations

# Guard for aggregate denominators (sums of client weights or of masked
# per-coordinate weights): far below any live weight sum, it only
# rescues an empty one.
DENOM_EPS = 1e-12

# Guard for rate rescales (1/kept_c and 1/(1 - loss_rate)): caps the
# debias multiplier at 1e6 instead of blowing a fully dropped client up.
RATE_EPS = 1e-6


# The most scenarios one launch holds where they lie on grid.y (its
# limit): a batched binding launches a chunk of at most this many at a
# time, and each scenario's outputs are those of its own launch.
MAX_SCENARIOS = 65535


def scenario_ptr(t, s0: int):
    """The address of scenario ``s0`` of ``t`` (None stays None): where
    a chunk's launch starts in a scenario-major operand."""
    if t is None:
        return None
    return t.data_ptr() + s0 * t.stride(0) * t.element_size() if s0 \
        else t.data_ptr()


def fold_rows(x, in_dim, batch: int):
    """A vmap rule's operand with the scenario axis first (broadcast when
    the operand has none), folded into the row axis: (B, R, ...) ->
    (B*R, ...), so one launch serves the whole batch."""
    x = x.unsqueeze(0).expand(batch, *x.shape) if in_dim is None \
        else x.movedim(in_dim, 0)
    return x.reshape(batch * x.shape[1], *x.shape[2:])
