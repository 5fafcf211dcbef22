"""The port's flash-decode attention against the JAX reference.

On the CPU the ``repro_torch::flash_decode`` op runs its plain version
(``ref.flash_decode_ref``); it is held against the reference's Pallas
kernel in interpret mode and its jnp oracle. Inputs come from numpy
seeds; bf16 inputs are the same f32 draws rounded to bf16 by each
package (round to nearest even, bitwise the same). Tolerances:
- against the reference's interpret-mode kernel: f32 rtol/atol 2e-5,
  K/V in bf16 2e-2, the reference's own (tests/test_flash_decode.py);
- the port's plain version against the reference's oracle: rtol/atol
  2e-5 in both dtypes (both compute in f32 from the same values; only
  the einsum's summation order differs);
- the masks (past pos, the sliding window, is_global): rtol 1e-5 /
  atol 1e-6, the reference's;
- decode attention against the model's decode attention: rtol 2e-4 /
  atol 2e-5, the reference's;
- ``decode_bias``: bitwise.
The CUDA kernel's own tests are in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.flash_decode import flash_decode_call
from repro.kernels.flash_decode.ops import decode_bias as j_decode_bias
from repro.kernels.flash_decode.ops import flash_decode as j_flash_decode
from repro.kernels.flash_decode.ref import flash_decode_ref as j_ref
from repro.models import attention as j_attn
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels.flash_decode import flash_decode as t_fd
from repro_torch.kernels.flash_decode.ops import decode_bias, flash_decode
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.models import attention as t_attn

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(a, dtype):
    """The same numpy draw as a JAX array and a CPU tensor of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,KV,G,dh,T,blk", [
    (1, 2, 4, 64, 256, 128),
    (2, 4, 1, 128, 512, 512),     # MHA-like, single block
    (2, 1, 8, 64, 1024, 256),     # extreme GQA
    (1, 2, 2, 32, 384, 128),      # non-power-of-two T multiple
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_matches_reference(B, KV, G, dh, T, blk, dtype):
    q, k, v = draws(B * T + G, (B, KV, G, dh), (B, T, KV, dh),
                    (B, T, KV, dh))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    pos = T - 3
    jb = j_decode_bias(T, jnp.int32(pos))
    tb = decode_bias(T, pos)
    kern = flash_decode_call(jq, jk, jv, jb, t_blk=blk, interpret=True)
    oracle = j_ref(jq, jk, jv, jb)
    port_ref = flash_decode_ref(tq, tk, tv, tb)
    port_op = flash_decode(tq.reshape(B, KV * G, dh), tk, tv, pos, t_blk=blk)
    tol = DTYPES[dtype][2]
    assert port_ref.dtype == port_op.dtype == torch.float32
    close(port_ref, oracle, 2e-5)
    close(port_ref, kern, tol)
    close(port_op.reshape(B, KV, G, dh), kern, tol)


@pytest.mark.parametrize("T", [1, 25, 100, 384])
@pytest.mark.parametrize("B,KV,G,dh", [(2, 20, 1, 128), (1, 2, 3, 80),
                                       (2, 4, 12, 32), (1, 1, 2, 64),
                                       (1, 2, 16, 64), (2, 2, 6, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_ragged_T(T, B, KV, G, dh, dtype):
    """Any T >= 1 with the default t_blk, against the reference's oracle
    (its kernel runs only with T a multiple of its block)."""
    q, k, v = draws(T + dh + G, (B, KV, G, dh), (B, T, KV, dh),
                    (B, T, KV, dh))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    pos = max(0, T - 2)
    want = j_ref(jq, jk, jv, j_decode_bias(T, jnp.int32(pos)))
    out = flash_decode(tq.reshape(B, KV * G, dh), tk, tv, pos)
    close(out.reshape(B, KV, G, dh), want, 2e-5)


@pytest.mark.parametrize("T", [1, 25, 100, 384, 32768])
@pytest.mark.parametrize("B,KV,G,dh,elem", [
    (2, 20, 1, 128, 4), (2, 32, 1, 80, 4), (2, 4, 12, 128, 4),
    (8, 20, 1, 128, 2), (8, 4, 12, 128, 2), (1, 16, 2, 80, 2),
    (1, 1, 1, 256, 4), (4, 2, 5, 32, 4), (2, 8, 6, 128, 2),
    (2, 4, 16, 128, 4)])
def test_launch_plan_covers_the_work(T, B, KV, G, dh, elem):
    """The kernel's geometry: every T row in exactly one non-empty split,
    every query head in one CTA's head set of at most 16, G <= 2 on the
    row loop and the rest on tiles (tensor cores for bf16), the tile ring
    within an SM's shared memory for the CTAs the plan puts there."""
    for t_blk in (1, 64, 512):
        p = t_fd.plan(B, KV, G, dh, T, elem, t_blk, n_sms=132)
        assert p.n_splits >= 1 and (p.n_splits - 1) * p.split_len < T \
            <= p.n_splits * p.split_len
        assert p.n_splits == 1 or p.split_len >= min(t_blk, T)
        assert 1 <= p.heads <= 16 and p.heads * p.n_hc >= G \
            > p.heads * (p.n_hc - 1)
        assert p.smem <= t_fd.SMEM_PER_CTA
        assert p.ctas_per_sm * (p.smem + t_fd.SMEM_RESERVED) \
            <= t_fd.SMEM_PER_SM
        if G <= t_fd.ROWS_MAX_G:
            assert p.kind == "rows" and p.heads == G
            ch = dh * elem // 16
            assert p.lpr & (p.lpr - 1) == 0 and p.lpr <= 32
            assert p.lpr * p.cpl >= ch and p.cpl in ((1,) if elem == 2
                                                     else (1, 2))
        else:
            assert p.kind == ("mma" if elem == 2 else "simt")
            assert p.heads == min(G, 16) and 2 <= p.stages <= 4
            assert p.tile == t_fd.TILE_ROWS[p.kind]
            assert p.smem == t_fd._tile_smem(p.kind, dh, p.stages)
            # no more splits than one wave of CTAs asks for
            assert p.n_splits == 1 or B * KV * p.n_hc * p.n_splits \
                <= p.ctas_per_sm * 132
    # the serves' shapes are one split: one pass, no combine
    assert t_fd.plan(2, 20, 1, 128, 25, 4, 512, 132).n_splits == 1
    assert t_fd.plan(2, 4, 12, 128, 25, 4, 512, 132).n_splits == 1


def test_launch_plan_is_cached():
    t_fd.plan.cache_clear()
    a = t_fd.plan(2, 4, 12, 128, 25, 4, 512, 132)
    assert t_fd.plan(2, 4, 12, 128, 25, 4, 512, 132) is a
    assert t_fd.plan.cache_info().hits >= 1


def test_flash_decode_respects_pos_mask():
    """Tokens beyond pos must not influence the output."""
    B, KV, G, dh, T = 1, 2, 2, 32, 256
    q, k, v = draws(0, (B, KV * G, dh), (B, T, KV, dh), (B, T, KV, dh))
    pos = 100
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    out1 = flash_decode(tq, tk, tv, pos, t_blk=128)
    k2, v2 = tk.clone(), tv.clone()
    k2[:, pos + 1:] = 99.0
    v2[:, pos + 1:] = -99.0
    out2 = flash_decode(tq, k2, v2, pos, t_blk=128)
    close(out1, out2, 1e-6)
    ref = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.int32(pos), t_blk=128)
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("is_global", [None, False, True])
@pytest.mark.parametrize("pos", [200, 255])
def test_flash_decode_sliding_window(is_global, pos):
    """The window masks the rows before pos - W + 1 (masked rows first)
    and pos masks those after it (masked rows last); a global layer sees
    everything up to pos."""
    B, KV, G, dh, T, W = 1, 1, 2, 32, 256, 16
    q, k, v = draws(1, (B, KV * G, dh), (B, T, KV, dh), (B, T, KV, dh))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    out = flash_decode(tq, tk, tv, pos, window=W, is_global=is_global,
                       t_blk=128)
    jg = None if is_global is None else jnp.bool_(is_global)
    ref = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.int32(pos), window=W, is_global=jg, t_blk=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    kern = flash_decode_call(
        jnp.asarray(q).reshape(B, KV, G, dh), jnp.asarray(k),
        jnp.asarray(v), j_decode_bias(T, jnp.int32(pos), W, jg), t_blk=128,
        interpret=True)
    close(out.reshape(B, KV, G, dh), kern, 2e-5)


@pytest.mark.parametrize("T,pos,window,is_global", [
    (64, 63, None, None), (64, 0, None, None), (25, 7, None, None),
    (256, 200, 16, None), (256, 200, 16, False), (256, 200, 16, True),
    (40, 3, 16, False), (1, 0, 4, True)])
def test_decode_bias_bitwise(T, pos, window, is_global):
    jg = None if is_global is None else jnp.bool_(is_global)
    want = np.asarray(j_decode_bias(T, jnp.int32(pos), window, jg))
    got = decode_bias(T, pos, window, is_global)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_flash_decode_matches_model_decode_attention():
    """The port's decode attention (through flash_decode) against the
    reference's model decode attention on the same params and cache, and
    the reference test's composition redone with the port's kernel op on
    the updated cache."""
    d, H, KV, dh, B, T = 64, 4, 2, 16, 2, 64
    jp = j_attn.attn_init(jax.random.PRNGKey(2), d, H, KV, dh)
    x, ck, cv = draws(3, (B, 1, d), (B, T, KV, dh), (B, T, KV, dh))
    pos = T - 1
    j_out, j_ck, _ = j_attn.decode_attn_apply(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(pos), rope_theta=10_000.0)
    tp = model_params_from_jax(jp, "cpu")
    tck, tcv = torch.tensor(ck), torch.tensor(cv)
    t_out, t_ck, t_cv = t_attn.decode_attn_apply(
        tp, torch.tensor(x), tck, tcv, pos, rope_theta=10_000.0)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(t_ck.numpy(), np.asarray(j_ck), rtol=2e-5,
                               atol=2e-6)
    cos, sin = t_attn.rope_freqs(dh, 10_000.0, torch.tensor([pos]))
    q, _, _ = t_attn._project_qkv(tp, torch.tensor(x), cos, sin)
    o = flash_decode(q, t_ck, t_cv, pos, t_blk=64)
    out_kernel = torch.einsum("bhk,hkd->bd", o, tp["wo"])
    np.testing.assert_allclose(out_kernel.numpy(), np.asarray(j_out[:, 0]),
                               rtol=2e-4, atol=2e-5)


def test_kernel_binding_refuses_cpu_tensors():
    q, k, v = (torch.zeros(s) for s in ((1, 1, 1, 32), (1, 4, 1, 32),
                                        (1, 4, 1, 32)))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_fd.flash_decode_call(q, k, v, torch.zeros(4))
