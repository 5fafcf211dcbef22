"""Division-guard epsilons shared by the port's kernels, their plain
versions and the engine: the single source, so a kernel and its plain
version can never drift apart on a guard."""
from __future__ import annotations

# Guard for aggregate denominators (sums of client weights or of masked
# per-coordinate weights): far below any live weight sum, it only
# rescues an empty one.
DENOM_EPS = 1e-12

# Guard for rate rescales (1/kept_c and 1/(1 - loss_rate)): caps the
# debias multiplier at 1e6 instead of blowing a fully dropped client up.
RATE_EPS = 1e-6
