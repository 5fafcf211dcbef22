"""Shared neural-net layers: RMSNorm, RoPE, MLPs, initializers.

The reference's ``repro/models/layers.py`` in PyTorch. ``params`` are
nested dicts of tensors; the decoder stack's leaves are stacked on a
leading ``L`` axis, as in the reference, and ``models/decode.py`` walks
that axis in a Python loop where the reference scans it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def truncated_normal(gen: torch.Generator, shape, std=0.02,
                     dtype=torch.float32) -> torch.Tensor:
    """``std`` times a normal truncated at +-2, drawn from ``gen`` on its
    device: ``jax.random.truncated_normal``'s method (a uniform between
    erf(-2/sqrt2) and erf(2/sqrt2), then sqrt2 * erfinv, clipped inside
    the bounds), in place on one buffer so a full-width leaf costs one
    allocation. The numbers are not JAX's: tests hand both packages the
    same weights (``convert.model_params_from_jax``)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    edge = math.nextafter(2.0, 0.0)
    x = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    x.mul_(hi - lo).add_(lo).erfinv_().mul_(math.sqrt(2.0))
    return x.clamp_(-edge, edge).mul_(std).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    """f32 statistics and the ``(1 + scale)`` gain, cast back to x's
    dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dh: int, theta: float, positions: torch.Tensor):
    """positions: (...,) integer -> (..., dh//2) cos/sin tables."""
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, dh); cos/sin: (S, dh//2) or broadcastable. The
    half-split rotation (first half against second), not interleaved."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def swiglu(x, wi, wg, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def gelu_mlp(x, wi, wo):
    return F.gelu(x @ wi, approximate="tanh") @ wo


def mlp_apply(x, p):
    if "wg" in p:
        return swiglu(x, p["wi"], p["wg"], p["wo"])
    return gelu_mlp(x, p["wi"], p["wo"])


def mlp_init(gen, d, f, gelu: bool, dtype, stack=()):
    p = {
        "wi": truncated_normal(gen, (*stack, d, f), dtype=dtype),
        "wo": truncated_normal(gen, (*stack, f, d), std=0.02 / 2,
                               dtype=dtype),
    }
    if not gelu:
        p["wg"] = truncated_normal(gen, (*stack, d, f), dtype=dtype)
    return p


def softmax_cross_entropy(logits, labels, label_mask=None):
    """logits (..., V) f32-accumulated CE; labels integer (...,)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if label_mask is not None:
        loss = loss * label_mask
        return loss.sum() / torch.clamp(label_mask.sum(), min=1.0)
    return loss.mean()
