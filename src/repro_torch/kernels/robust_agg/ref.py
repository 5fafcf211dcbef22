"""Plain PyTorch version of the robust-aggregation kernel.

Expression for expression the reference's jnp oracle
(``repro/kernels/robust_agg/ref.py``). With the gates off it is the
undefended ``uplink_fused/ref.py`` math bit for bit: sanitisation and
mask tightening go through ``torch.where`` on the gate predicate, which
passes the operand through untouched, never through ``x * gate``
arithmetic (``-0 + 0 = +0`` would break that). The trimmed mean sorts,
a different algorithm from the kernel's k-pass extraction, so the two
are independent implementations of one estimator. The engine runs this
for tensors on the CPU; the tests and ``chip_smoke.py`` hold the CUDA
kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import DENOM_EPS

# Invalid-slot sentinel of the trimmed mean: beyond any f32 the engine
# produces once screened, so invalid slots sort past every real value
# without becoming inf (inf - inf traps).
TRIM_BIG = 3.0e38


def masked_trimmed_mean(y, valid, k: int):
    """Coordinate-wise k-trimmed mean over the client axis.

    y: (..., C, P, F) per-client debias-scaled estimates; valid:
    (..., C, P) f32 per-packet validity (delivery x screen x weight > 0).
    Per coordinate, drop the k largest and k smallest valid values and
    average the rest; coordinates with <= 2k valid values fall back to
    the plain masked mean. Returns (..., P, F).
    """
    C = y.shape[-3]
    vf = valid[..., None]
    vb = vf > 0.0
    n = vf.sum(-3)                                       # (..., P, 1)
    total = (y * vf).sum(-3)                             # (..., P, F)
    lo = torch.sort(torch.where(vb, y, TRIM_BIG), dim=-3).values
    hi = torch.sort(torch.where(vb, y, -TRIM_BIG), dim=-3).values
    bot = lo[..., :k, :, :].sum(-3)
    top = hi[..., C - k:, :, :].sum(-3)
    cnt = torch.clamp(n - 2.0 * k, min=1.0)
    return torch.where(n > 2.0 * k, (total - top - bot) / cnt,
                       total / torch.clamp(n, min=1.0))


def robust_ref(x, m, q, w_or_den, *, ef=None, screen, trim_gate,
               g=None, w_pos=None, trim_k: int = 0, per_coord: bool,
               eps: float = DENOM_EPS):
    """x: (C, P, F) unmasked uploads after fault injection; ef:
    (C, P, F) or None; m: (C, P) delivery mask; q: (C,) debias scales
    with the clip factor folded in; ``w_or_den`` as in ``uplink_ref``;
    ``screen`` / ``trim_gate``: () f32 gates; ``g`` (C,) the per-client
    trim estimate scale and ``w_pos`` (C,) the weight > 0 validity (both
    only when ``trim_k > 0``).

    Returns (agg (P, F) f32, ef_out (C, P, F) | None, the screened mask
    m_eff (C, P)). Every operand may carry a leading scenario axis S
    (the batched kernel's plain version); each scenario is its own.
    """
    x = x.float()
    if ef is not None:
        x = x + ef.float()
    fin = torch.isfinite(x)
    scr = screen > 0.5
    # quarantine: a delivered-but-bad packet becomes as if lost (its mask
    # bit drops, the debias re-inflates survivors as for channel loss)
    # and its payload zeroes, so NaN cannot ride x * 0 into the sum
    x = torch.where(scr[..., None, None, None] & ~fin, 0.0, x)
    m_eff = torch.where(scr[..., None, None], m * fin.all(-1).float(), m)
    wm = m_eff * q[..., None]
    num = torch.einsum("...cpf,...cp->...pf", x, wm)
    if per_coord:
        den = torch.clamp((m_eff * w_or_den[..., None]).sum(-2),
                          min=eps)[..., None]
    else:
        den = w_or_den[..., None, None]
    agg = num / den
    if trim_k > 0:
        y = x * g[..., None, None]
        agg_t = masked_trimmed_mean(y, m_eff * w_pos[..., None], trim_k)
        agg = torch.where(trim_gate[..., None, None] > 0.5, agg_t, agg)
    # EF keeps only channel-lost packets (the original mask): quarantined
    # payloads are never recycled. With the screen on it stays finite.
    ef_out = x * (1.0 - m[..., None]) if ef is not None else None
    return agg, ef_out, m_eff
