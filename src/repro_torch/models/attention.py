"""GQA attention: parameters, the QKV projection and the KV-cache decode
path (the reference's ``repro/models/attention.py``).

The decode attention goes through the port's flash-decode kernel
(``kernels/flash_decode``): every decode step of every layer launches
it once on the card, where the reference computes the same math in
plain ``jnp``. The chunked train/prefill attention and the cross
attention come with training and the encoder-decoder family.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models.layers import apply_rope, rope_freqs, truncated_normal


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def attn_init(gen, d, n_heads, n_kv, dh, *, qkv_bias=False,
              dtype=torch.float32, stack=()):
    p = {
        "wq": truncated_normal(gen, (*stack, d, n_heads, dh), dtype=dtype),
        "wk": truncated_normal(gen, (*stack, d, n_kv, dh), dtype=dtype),
        "wv": truncated_normal(gen, (*stack, d, n_kv, dh), dtype=dtype),
        "wo": truncated_normal(gen, (*stack, n_heads, dh, d), std=0.02 / 2,
                               dtype=dtype),
    }
    if qkv_bias:
        zeros = dict(dtype=dtype, device=gen.device)
        p["bq"] = torch.zeros((*stack, n_heads, dh), **zeros)
        p["bk"] = torch.zeros((*stack, n_kv, dh), **zeros)
        p["bv"] = torch.zeros((*stack, n_kv, dh), **zeros)
    return p


def _project_qkv(p, x, cos, sin, *, rope=True):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


# ---------------------------------------------------------------------------
# decode (one token vs KV cache)
# ---------------------------------------------------------------------------
def decode_attn_apply(p, x, cache_k, cache_v, pos: int, *, rope_theta,
                      window=None, is_global=None, bias=None):
    """x: (B,1,d). cache_k/v: (B,T,KV,dh) with valid entries < pos.

    Writes the new token's k and v into the caches at ``pos`` IN PLACE
    (the reference returns updated copies) and returns
    (out (B,1,d), cache_k, cache_v), the same cache tensors. ``pos`` is a
    Python int in [0, T): where ``jax.lax.dynamic_update_slice`` clamps a
    write outside the cache silently, this raises. ``bias`` is the (T,)
    mask ``fd_ops.decode_bias(T, pos, window, is_global)`` would build,
    when the caller builds it once for many layers.
    """
    dh = p["wq"].shape[-1]
    T = cache_k.shape[1]
    pos = int(pos)
    if not 0 <= pos < T:
        raise IndexError(f"decode position {pos} outside the cache's "
                         f"[0, {T})")
    cos, sin = rope_freqs(dh, rope_theta,
                          torch.full((1,), pos, device=x.device))
    q, k_new, v_new = _project_qkv(p, x, cos, sin)        # (B,1,H,dh)
    cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
    o = fd_ops.flash_decode(q, cache_k, cache_v, pos, window=window,
                            is_global=is_global, bias=bias)  # (B,H,dh) f32
    out = torch.einsum("bhk,hkd->bd", o.to(x.dtype), p["wo"])
    return out[:, None], cache_k, cache_v
