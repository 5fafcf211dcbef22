"""The port's model code (``repro_torch.models``) against the JAX
reference: the layers, the parameter trees, decode attention and the
dense family's decode step.

Inputs come from numpy seeds; weights are the reference's, handed over
with ``convert.model_params_from_jax``. Tolerances:
- layers (rms_norm, RoPE, the MLPs): rtol 1e-5 / atol 1e-6 (f32; the
  matmuls sum in another order);
- decode attention: rtol 2e-4 / atol 2e-5, the reference's own for its
  decode-attention parity (tests/test_flash_decode.py); the updated
  cache rtol 2e-5 / atol 2e-6;
- the decode step, 20 steps from the same tokens: logits rtol 2e-4 /
  atol 2e-5 every step, caches rtol 2e-4 / atol 2e-5 at the end;
- parameter trees: keys, shapes and dtypes equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import decode as j_decode
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch.configs.base import get_config
from repro_torch.convert import cache_from_jax, model_params_from_jax
from repro_torch.models import attention as t_attn
from repro_torch.models import decode as t_decode
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf

DENSE = ("qwen1.5-4b", "stablelm-3b", "starcoder2-15b", "gemma3-27b")
NON_DENSE = ("qwen3-moe-235b-a22b", "zamba2-7b", "internvl2-2b",
             "whisper-large-v3", "mixtral-8x22b", "xlstm-350m")
# reduced() keeps n_kv_heads = n_heads for every dense arch; these two
# GQA variants give the model tests a G > 1
GQA = (("starcoder2-15b", 2), ("gemma3-27b", 2))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def reduced(name, kv=None):
    """The reduced config in both packages (GQA variant when ``kv``)."""
    jc, tc = j_get_config(name).reduced(), get_config(name).reduced()
    if kv is not None:
        jc = dataclasses.replace(jc, n_kv_heads=kv)
        tc = dataclasses.replace(tc, n_kv_heads=kv)
    return jc, tc


def test_rms_norm_and_rope():
    x, scale = (np.random.default_rng(0).standard_normal(s).astype(
        np.float32) for s in ((2, 3, 4, 32), (32,)))
    close(t_layers.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6),
          j_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    pos = np.array([0, 5, 24], np.int32)
    for theta in (10_000.0, 1_000_000.0):
        tc, ts = t_layers.rope_freqs(32, theta, torch.tensor(pos))
        jc, js = j_layers.rope_freqs(32, theta, jnp.asarray(pos))
        close(tc, jc)
        close(ts, js)
        close(t_layers.apply_rope(torch.tensor(x), tc, ts),
              j_layers.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("gelu", [False, True])
def test_mlp(gelu):
    jp = j_layers.mlp_init(jax.random.PRNGKey(1), 64, 96, gelu, jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 1, 64)).astype(
        np.float32)
    close(t_layers.mlp_apply(torch.tensor(x),
                             model_params_from_jax(jp, "cpu")),
          j_layers.mlp_apply(jnp.asarray(x), jp))
    tp = t_layers.mlp_init(torch.Generator().manual_seed(1), 64, 96, gelu,
                           torch.float32)
    assert sorted(tp) == sorted(jp)
    assert all(tuple(tp[k].shape) == jp[k].shape for k in jp)


def test_truncated_normal():
    """The numbers are not JAX's; the law is: within +-2 std, mean 0 and
    the truncated normal's std (0.8796 of the normal's), dtype kept."""
    t = t_layers.truncated_normal(torch.Generator().manual_seed(0),
                                  (400, 500), std=0.02)
    assert t.dtype == torch.float32 and t.shape == (400, 500)
    assert float(t.abs().max()) < 0.04
    assert abs(float(t.mean())) < 2e-4
    assert abs(float(t.std()) / 0.02 - 0.8796) < 5e-3
    b = t_layers.truncated_normal(torch.Generator().manual_seed(0), (3,),
                                  dtype=torch.bfloat16)
    assert b.dtype == torch.bfloat16


def tree_spec(tree):
    """{path: (shape, dtype name)} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in tree_spec(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(name, dtype):
    jc, tc = reduced(name)
    want = tree_spec(j_tf.init_params(jc, jax.random.PRNGKey(0),
                                      getattr(jnp, dtype)))
    tp = t_tf.init_params(tc, torch.Generator().manual_seed(0),
                          getattr(torch, dtype))
    assert tree_spec(tp) == want
    # zero norms and biases, std 0.02 weights and 0.01 output projections
    blocks = tp["blocks"]
    assert not tp["final_norm"].any() and not blocks["norm1"].any()
    if "bq" in blocks["attn"]:
        assert not blocks["attn"]["bq"].any()
    for leaf, std in ((blocks["attn"]["wq"], 0.02),
                      (blocks["attn"]["wo"], 0.01),
                      (blocks["mlp"]["wo"], 0.01), (tp["embed"], 0.02)):
        assert abs(float(leaf.float().std()) / std - 0.8796) < 0.05
        # +-2 std, and one rounding to the leaf's dtype
        eps = torch.finfo(leaf.dtype).eps
        assert float(leaf.float().abs().max()) <= 2 * std * (1 + eps)


def test_attn_init_matches_reference():
    for bias in (False, True):
        jp = j_attn.attn_init(jax.random.PRNGKey(0), 64, 4, 2, 16,
                              qkv_bias=bias, stack=(3,))
        tp = t_attn.attn_init(torch.Generator().manual_seed(0), 64, 4, 2, 16,
                              qkv_bias=bias, stack=(3,))
        assert tree_spec(tp) == tree_spec(jp)


@pytest.mark.parametrize("window,is_global,pos", [
    (None, None, 10), (8, False, 20), (8, True, 20), (8, False, 3)])
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_decode_attn_apply_matches_reference(window, is_global, pos, kv):
    d, H, dh, B, T = 64, 4, 16, 2, 24
    jp = j_attn.attn_init(jax.random.PRNGKey(kv), d, H, kv, dh,
                          qkv_bias=True)
    rng = np.random.default_rng(pos + kv)
    jp = dict(jp, bq=jnp.asarray(rng.standard_normal((H, dh)), jnp.float32))
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, T, kv, dh)).astype(np.float32)
              for _ in range(2))
    jg = None if is_global is None else jnp.bool_(is_global)
    j_out, j_ck, j_cv = j_attn.decode_attn_apply(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(pos), rope_theta=10_000.0, window=window, is_global=jg)
    tck, tcv = torch.tensor(ck), torch.tensor(cv)
    t_out, t_ck, t_cv = t_attn.decode_attn_apply(
        model_params_from_jax(jp, "cpu"), torch.tensor(x), tck.clone(),
        tcv.clone(), pos, rope_theta=10_000.0, window=window,
        is_global=is_global)
    close(t_out, j_out, 2e-4, 2e-5)
    close(t_ck, j_ck, 2e-5, 2e-6)
    close(t_cv, j_cv, 2e-5, 2e-6)
    # in place: the port's cache tensors are the updated ones
    t_attn.decode_attn_apply(model_params_from_jax(jp, "cpu"),
                             torch.tensor(x), tck, tcv, pos,
                             rope_theta=10_000.0, window=window,
                             is_global=is_global)
    close(tck, j_ck, 2e-5, 2e-6)


def test_decode_position_outside_the_cache():
    """jax.lax.dynamic_update_slice clamps a write at pos >= T to the last
    row, silently; the port raises."""
    d, H, dh, B, T = 32, 2, 16, 1, 8
    jp = j_attn.attn_init(jax.random.PRNGKey(0), d, H, H, dh)
    x = np.random.default_rng(0).standard_normal((B, 1, d)).astype(
        np.float32)
    zeros = np.zeros((B, T, H, dh), np.float32)
    _, j_ck, _ = j_attn.decode_attn_apply(
        jp, jnp.asarray(x), jnp.asarray(zeros), jnp.asarray(zeros),
        jnp.int32(T), rope_theta=10_000.0)
    j_ck = np.asarray(j_ck)
    assert np.abs(j_ck[:, T - 1]).sum() > 0 and not j_ck[:, :T - 1].any()
    tp = model_params_from_jax(jp, "cpu")
    for pos in (T, T + 3, -1):
        with pytest.raises(IndexError, match="outside the cache"):
            t_attn.decode_attn_apply(tp, torch.tensor(x),
                                     torch.tensor(zeros),
                                     torch.tensor(zeros), pos,
                                     rope_theta=10_000.0)


@pytest.mark.parametrize("name,kv", [(n, None) for n in DENSE] + list(GQA))
def test_decode_step_matches_reference(name, kv):
    """20 decode steps from an empty cache with the same tokens fed to
    both (so a difference cannot feed back through a token); with
    T = 24 the reduced window of 16 is crossed."""
    jc, tc = reduced(name, kv)
    B, T, steps = 2, 24, 20
    jparams = j_tf.init_params(jc, jax.random.PRNGKey(3))
    tparams = model_params_from_jax(jparams, "cpu")
    jcache = j_decode.init_cache(jc, B, T, jnp.float32)
    tcache = t_decode.init_cache(tc, B, T, torch.float32)
    assert tree_spec(tcache) == tree_spec(jcache)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (steps, B, 1))
    step = jax.jit(lambda p, c, t, pos: j_decode.decode_step(jc, p, t, c,
                                                             pos))
    for i in range(steps):
        j_logits, jcache = step(jparams, jcache, jnp.asarray(toks[i],
                                                             jnp.int32),
                                jnp.int32(i))
        t_logits, tcache = t_decode.decode_step(
            tc, tparams, torch.tensor(toks[i], dtype=torch.int32), tcache, i)
        assert t_logits.dtype == torch.float32
        close(t_logits, j_logits, 2e-4, 2e-5)
    for key in ("k", "v"):
        close(tcache[key], jcache[key], 2e-4, 2e-5)
    # a decode continued from the reference's cache gives its logits
    jl, _ = step(jparams, jcache, jnp.asarray(toks[0], jnp.int32),
                 jnp.int32(steps))
    tl, _ = t_decode.decode_step(tc, tparams,
                                 torch.tensor(toks[0], dtype=torch.int32),
                                 cache_from_jax(jcache, "cpu"), steps)
    close(tl, jl, 2e-4, 2e-5)


def test_layer_flags_match_reference():
    for name in DENSE + NON_DENSE:
        for cfg in (get_config(name), get_config(name).reduced()):
            jcfg = j_get_config(cfg.name.replace("-reduced", ""))
            if cfg.name.endswith("-reduced"):
                jcfg = jcfg.reduced()
            np.testing.assert_array_equal(t_tf.layer_flags(cfg),
                                          j_tf.layer_flags(jcfg))


@pytest.mark.parametrize("name", NON_DENSE)
def test_non_dense_families_raise(name):
    cfg = get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        t_tf.init_params(cfg, torch.Generator())
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        t_decode.init_cache(cfg, 1, 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        t_decode.decode_step(cfg, {}, torch.zeros((1, 1), dtype=torch.int32),
                             {}, 0)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        t_tf.forward(cfg, {}, batch)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        t_tf.prefill_logits(cfg, {}, batch)
