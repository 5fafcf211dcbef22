"""GQA attention: parameters, the QKV projection, the query-chunked
train/prefill attention and the KV-cache decode path (the reference's
``repro/models/attention.py``).

* Train/prefill attention walks the query blocks with an f32 softmax,
  so the live score buffer is ``(B, Cq, H, T)``, not ``(B, S, H, S)``.
  With autograd recording, each block is checkpointed: its scores and
  probabilities are recomputed in backward, as the reference's
  ``jax.checkpoint`` does. Sliding-window and gemma3-style local:global
  layers are expressed through the mask alone (``_band_mask``).
* The decode attention goes through the port's flash-decode kernel
  (``kernels/flash_decode``): every decode step of every layer launches
  it once on the card, where the reference computes the same math in
  plain ``jnp``.

The cross attention comes with the encoder-decoder family.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _band_mask(q_pos, k_pos, *, causal, window, is_global):
    """(Q, T) bool mask. window: int or None. is_global: a bool (or bool
    tensor) for the layer, or None."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        local = k_pos[None, :] > (q_pos[:, None] - window)
        if is_global is not None:   # per-layer flag: global layers see all
            local = local | is_global
        m &= local
    return m


# ---------------------------------------------------------------------------
# chunked attention (train / prefill)
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal=True, window=None, is_global=None,
              q_chunk=512, q_offset=0):
    """q: (B,S,H,dh)  k,v: (B,T,KV,dh)  ->  (B,S,H,dh).

    Query-chunked with f32 softmax; GQA via head-group reshape. Masked
    scores are -1e30.
    """
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    nc = max(1, S // q_chunk)
    C = S // nc
    if S % nc:
        raise ValueError(f"sequence {S} does not split into query chunks "
                         f"of about {q_chunk}")
    qg = q.reshape(B, nc, C, KV, G, dh)
    k_pos = torch.arange(T, device=q.device)

    def chunk_attn(qc, i):
        q_pos = q_offset + i * C + torch.arange(C, device=q.device)
        s = torch.einsum("bckgd,btkd->bckgt", qc, k).float() * scale
        mask = _band_mask(q_pos, k_pos, causal=causal, window=window,
                          is_global=is_global)
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
        p = torch.softmax(s, -1)
        return torch.einsum("bckgt,btkd->bckgd", p.to(v.dtype), v)

    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = [checkpoint(chunk_attn, qg[:, i], i, use_reentrant=False)
            if grad else chunk_attn(qg[:, i], i) for i in range(nc)]
    return torch.stack(outs, 1).reshape(B, S, H, dh)


def attn_apply(p, x, *, rope_theta, causal=True, window=None, is_global=None,
               q_chunk=512, positions=None):
    """Full self-attention over x: (B,S,d)."""
    B, S, d = x.shape
    dh = p["wq"].shape[-1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    cos, sin = rope_freqs(dh, rope_theta, positions)
    q, k, v = _project_qkv(p, x, cos, sin)
    o = attention(q, k, v, causal=causal, window=window, is_global=is_global,
                  q_chunk=min(q_chunk, S))
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out


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
