"""The port's serving launcher (``repro_torch.launch.serve``) and configs
against the JAX reference.

The reference's ``prefill_into_cache`` + ``make_serve_step`` greedy loop
and the port's run from the same weights (``convert``) and the same
numpy prompt. Tolerances: greedy tokens equal; the prefill's logits and
every serve step's logits rtol 2e-4 / atol 2e-5 (f32; the matmuls and
the softmax sum in another order). Configs: every field equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import serve as j_serve
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.models import decode as j_decode
from repro.models import transformer as j_tf
from repro_torch.configs import base as t_base
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import decode as t_decode


@pytest.mark.parametrize("name,kv", [("qwen1.5-4b", None),
                                     ("stablelm-3b", None),
                                     ("starcoder2-15b", 2),
                                     ("gemma3-27b", 2)])
def test_greedy_serve_matches_reference(name, kv):
    """Prompt 8, 12 new tokens (T = 21 crosses the reduced window of
    16): the serve loop's tokens equal, logits close at every step."""
    jc, tc = (b.get_config(name).reduced() for b in (j_base, t_base))
    if kv is not None:
        jc, tc = (dataclasses.replace(c, n_kv_heads=kv) for c in (jc, tc))
    _greedy_matches_reference(jc, tc)


def test_greedy_serve_gqa12_matches_reference():
    """starcoder2-15b's G = 12 at reduced width: 24 query heads over 2 kv
    heads (the card's tiled kernel runs this in tests/test_torch_cuda.py)."""
    jc, tc = (dataclasses.replace(b.get_config("starcoder2-15b").reduced(),
                                  n_heads=24, n_kv_heads=2)
              for b in (j_base, t_base))
    assert tc.n_heads // tc.n_kv_heads == 12
    _greedy_matches_reference(jc, tc)


def _greedy_matches_reference(jc, tc):
    B, P, N = 2, 8, 12
    T = P + N + 1
    prompt = np.random.default_rng(0).integers(0, jc.vocab, (B, P))
    jparams = j_tf.init_params(jc, jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jparams, "cpu")

    jl, jcache = j_serve.prefill_into_cache(
        jc, jparams, jnp.asarray(prompt, jnp.int32),
        j_decode.init_cache(jc, B, T, jnp.float32))
    tl, tcache = t_serve.prefill_into_cache(
        tc, tparams, torch.tensor(prompt, dtype=torch.int32),
        t_decode.init_cache(tc, B, T, torch.float32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-5)

    j_step = jax.jit(j_make_serve_step(jc))
    j_logits = jax.jit(lambda p, c, t, pos: j_decode.decode_step(jc, p, t, c,
                                                                 pos)[0])
    t_step = make_serve_step(tc)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = tl.argmax(-1).int()[:, None]
    for i in range(N):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        # the step's logits, from the caches both steps start from
        got = t_decode.decode_step(tc, tparams, tt, {
            k: c.clone() for k, c in tcache.items()}, P + i)[0]
        want = j_logits(jparams, jcache, jt, jnp.int32(P + i))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)
        jt, jcache = j_step(jparams, jcache, {"tokens": jt},
                            jnp.int32(P + i))
        tt, tcache = t_step(tparams, tcache, {"tokens": tt}, P + i)
        assert tt.dtype == torch.int32
        jt, tt = jt.reshape(B, 1), tt.reshape(B, 1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_serve_cli_reduced(capsys):
    """The entry point as tests/test_launchers_cli.py runs the reference's,
    in process and on the CPU."""
    assert t_serve.main(["--arch", "stablelm-3b", "--reduced", "--tokens",
                         "4", "--prompt-len", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 4 tokens" in out
    assert "decoded 4 tokens x 2 seqs" in out


def test_serve_run_defaults_reduced():
    """The launcher's defaults (qwen1.5-4b, batch 2, prompt 8, 16 tokens)
    on the reduced model: every token in the vocabulary, finite logits,
    and the reference's prompt."""
    res = t_serve.run(["--reduced", "--device", "cpu"])
    assert res.cfg.name == "qwen1.5-4b-reduced"
    assert res.tokens.shape == (2, 17) and res.tokens.dtype == torch.int32
    assert bool(((res.tokens >= 0) & (res.tokens < res.cfg.vocab)).all())
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert res.prefill_logits.shape == (2, res.cfg.vocab)


def test_serve_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("there is a card here: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.run(["--reduced", "--tokens", "1"])


@pytest.mark.parametrize("name", j_base.ASSIGNED)
def test_config_matches_reference(name):
    j, t = j_base.get_config(name), t_base.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for c, r in ((t, j), (t.reduced(), j.reduced())):
        assert (c.dh, c.is_moe, c.eff_d_ff, c.is_encdec, c.subquadratic,
                c.n_params(), c.n_active_params()) == (
            r.dh, r.is_moe, r.eff_d_ff, r.is_encdec, r.subquadratic,
            r.n_params(), r.n_active_params())


def test_config_registry():
    assert t_base.ASSIGNED == j_base.ASSIGNED
    assert t_base.FAMILIES == j_base.FAMILIES
    # the assigned archs and the token stand-in "synthetic-mlp", as the
    # reference registers them
    assert t_base.list_configs() == j_base.list_configs() == sorted(
        j_base.ASSIGNED + ("synthetic-mlp",))
    with pytest.raises(KeyError, match="unknown arch"):
        t_base.get_config("no-such-arch")
