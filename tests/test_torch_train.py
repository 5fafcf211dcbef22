"""The port's dense training path against the JAX reference: the
cross-entropy, the query-chunked attention, the training forward and
its gradients, the train and prefill steps, the input specs and the
``repro_torch.launch.train`` CLI.

Inputs come from numpy seeds; weights are the reference's, handed over
with ``convert.model_params_from_jax``. Tolerances (f32; the matmuls and
reductions sum in another order):
- cross-entropy: rtol 1e-6;
- the chunked attention and ``attn_apply``: rtol 1e-5 / atol 1e-6,
  their input gradients rtol 1e-4 / atol 1e-6 times the gradient's
  largest magnitude; the band mask bitwise;
- ``forward``: the loss rtol 1e-6, every gradient leaf atol 1e-5 times
  the leaf's largest reference magnitude (measured: up to 1.2e-6 of it);
- ``prefill_logits`` and ``stack_hidden``: rtol 1e-5 / atol 1e-5;
- three train steps, microbatch 2: losses rtol 1e-5, grad norms rtol
  1e-5; SGD's parameters rtol 1e-5 / atol 1e-7; AdamW's parameters
  atol 0.05 x lr and moments atol 1e-3 times the leaf's largest
  reference magnitude (measured: up to 2.2e-4 of it). Adam divides each
  moment by its root mean square plus eps = 1e-8, so a gradient of
  1e-9 whose last digits differ moves its update by a fraction of lr,
  and the next steps' gradients move with the parameters (one AdamW
  update is held tightly in tests/test_torch_optim.py);
- synthetic batches and tokens: bitwise.
Remat ("full", "dots") changes no value: bitwise the plain forward.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as j_get_config
from repro.launch import input_specs as j_specs
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import INPUT_SHAPES, TrainConfig, get_config
from repro_torch.convert import model_params_from_jax, tree_to_numpy
from repro_torch.launch import input_specs as t_specs
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import decode as t_decode
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.optim.optimizers import tree_leaves, tree_paths
from repro_torch.utils import shardctx

ARCHS = ("stablelm-3b", "qwen1.5-4b", "gemma3-27b")
B, S = 2, 32


def configs(name, **kw):
    jc, tc = j_get_config(name).reduced(), get_config(name).reduced()
    if kw:
        jc, tc = (dataclasses.replace(c, **kw) for c in (jc, tc))
    return jc, tc


def batch_np(cfg, seed, lead=(), seq=S):
    rng = np.random.default_rng(seed)
    shape = (*lead, B, seq)
    return {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32)}


def to_t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are tiny, and the suite's workers
    share the cores: one torch thread, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Each arch's reduced config, reference params (numpy) and one
    batch, with the reference's loss and gradients."""
    out = {}
    for name in ARCHS:
        jc, tc = configs(name)
        jp = jax.tree.map(np.asarray, j_tf.init_params(
            jc, jax.random.PRNGKey(0)))
        b = batch_np(jc, 1)
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, bb: j_tf.forward(jc, p, bb), has_aux=True))(jp, b)
        out[name] = dict(jc=jc, tc=tc, params=jp, batch=b, loss=float(jl),
                         ce=float(jm["ce"]),
                         grads=jax.tree.map(np.asarray, jg))
    return out


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------
def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = j_layers.softmax_cross_entropy(
            logits, labels, None if m is None else jnp.asarray(m))
        got = t_layers.softmax_cross_entropy(
            torch.tensor(logits), torch.tensor(labels),
            None if m is None else torch.tensor(m))
        close(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("causal,window,is_global", [
    (True, None, None), (False, None, None), (True, 4, None),
    (True, 4, False), (True, 4, True), (False, 3, False)])
def test_band_mask_matches_reference(causal, window, is_global):
    q_pos, k_pos = np.arange(8, 20), np.arange(24)
    want = j_attn._band_mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                             causal=causal, window=window,
                             is_global=None if is_global is None
                             else jnp.asarray(is_global))
    got = t_attn._band_mask(torch.tensor(q_pos), torch.tensor(k_pos),
                            causal=causal, window=window, is_global=is_global)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


ATTN_CASES = {
    # (H, KV, dh, kwargs): causal MHA, gemma3's local and global layers
    # (reduced: window 16), a GQA group of 2 (starcoder2-15b reduced with
    # 2 kv heads), a non-causal chunk and a query offset
    "causal": (4, 4, 32, dict(causal=True)),
    "band_local": (4, 4, 32, dict(causal=True, window=16, is_global=False)),
    "band_global": (4, 4, 32, dict(causal=True, window=16, is_global=True)),
    "gqa": (4, 2, 32, dict(causal=True)),
    "noncausal": (4, 2, 32, dict(causal=False)),
    "offset": (4, 4, 32, dict(causal=True, window=16, is_global=False,
                              q_offset=8)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_reference(case):
    """S = 32, q_chunk 8 (4 chunks): outputs and the input gradients of
    a seeded cotangent."""
    H, KV, dh, kw = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S + 8, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S + 8, KV, dh)).astype(np.float32)
    ct = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    jkw = dict(kw)
    if jkw.get("is_global") is not None:
        jkw["is_global"] = jnp.asarray(jkw["is_global"])

    @jax.jit
    def jf(q, k, v, ct):
        out, vjp = jax.vjp(lambda *a: j_attn.attention(*a, q_chunk=8, **jkw),
                           q, k, v)
        return out, vjp(ct)
    jo, jgrads = jf(q, k, v, ct)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = t_attn.attention(tq, tk, tv, q_chunk=8, **kw)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.tensor(ct))
    close(to.detach(), jo)
    for g, w in zip(tgrads, jgrads):
        close(g, w, rtol=1e-4, atol=1e-6 * float(np.abs(w).max()))
    # no grad: the same values without checkpointing
    with torch.no_grad():
        close(t_attn.attention(tq, tk, tv, q_chunk=8, **kw), jo)


def test_attention_refuses_an_uneven_chunking():
    q = torch.zeros((1, 9, 2, 8))
    with pytest.raises(ValueError, match="query chunks"):
        t_attn.attention(q, q, q, q_chunk=4)


def test_attn_apply_matches_reference(models):
    m = models["qwen1.5-4b"]
    p = jax.tree.map(lambda x: x[0], m["params"]["blocks"]["attn"])
    x = np.random.default_rng(4).standard_normal(
        (B, S, m["jc"].d_model)).astype(np.float32)
    want = j_attn.attn_apply(p, x, rope_theta=m["jc"].rope_theta,
                             q_chunk=8)
    got = t_attn.attn_apply(model_params_from_jax(p, "cpu"),
                            torch.tensor(x), rope_theta=m["tc"].rope_theta,
                            q_chunk=8)
    close(got, want)


# ---------------------------------------------------------------------------
# the forward and its gradients
# ---------------------------------------------------------------------------
def port_loss_grads(m, remat=False):
    tp = model_params_from_jax(m["params"], "cpu")
    (loss, metrics), grads = t_steps.value_and_grad(
        lambda p: t_tf.forward(m["tc"], p, to_t(m["batch"]), remat=remat),
        tp)
    return loss, metrics, grads


@pytest.mark.parametrize("name", ARCHS)
def test_forward_loss_and_grads_match_reference(models, name):
    """stablelm-3b (untied head), qwen1.5-4b (QKV bias) and gemma3-27b
    (tied embeddings scaled by sqrt(d), the band mask at S = 32 past the
    reduced window of 16), reduced: loss and every gradient leaf."""
    m = models[name]
    loss, metrics, grads = port_loss_grads(m)
    close(float(loss), m["loss"], rtol=1e-6, atol=0)
    close(float(metrics["ce"]), m["ce"], rtol=1e-6, atol=0)
    assert float(metrics["moe_aux"]) == 0.0
    want = m["grads"]
    got = tree_to_numpy(grads)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(tree_paths(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_value(models, remat):
    """Checkpointing is a memory device: loss and gradients bitwise the
    plain forward's."""
    m = models["gemma3-27b"]
    l0, _, g0 = port_loss_grads(m)
    l1, _, g1 = port_loss_grads(m, remat=remat)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_chunked_ce_walks_chunks_like_reference(monkeypatch):
    """S = 48 with CE_CHUNK 16 (3 chunks) and S = 40 (the while-walk
    settles on 2 chunks of 20): the reference's chunking, its loss."""
    jc, tc = configs("stablelm-3b")
    jp = j_tf.init_params(jc, jax.random.PRNGKey(1))
    tp = model_params_from_jax(jp, "cpu")
    monkeypatch.setattr(j_tf, "CE_CHUNK", 16)
    monkeypatch.setattr(t_tf, "CE_CHUNK", 16)
    for seq in (48, 40):
        b = batch_np(jc, 5, seq=seq)
        h = np.random.default_rng(seq).standard_normal(
            (B, seq, jc.d_model)).astype(np.float32)
        jl, _ = j_tf._chunked_ce(jc, jp, jnp.asarray(h), b)
        tl, tm = t_tf._chunked_ce(tc, tp, torch.tensor(h), to_t(b))
        close(float(tl), float(jl), rtol=1e-6, atol=0)
        assert tm["ce"] is tl


def test_prefill_logits_and_stack_hidden_match_reference(models):
    m = models["gemma3-27b"]
    tp = model_params_from_jax(m["params"], "cpu")
    b = {"tokens": m["batch"]["tokens"]}
    jh, jaux = j_tf.stack_hidden(m["jc"], m["params"], b)
    th, taux = t_tf.stack_hidden(m["tc"], tp, to_t(b))
    close(th, jh, rtol=1e-5, atol=1e-5)
    assert float(taux) == float(jaux) == 0.0
    want = j_steps.make_prefill_step(m["jc"])(m["params"], b)
    got = t_steps.make_prefill_step(m["tc"])(tp, to_t(b))
    assert got.dtype == torch.float32 and not got.requires_grad
    close(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_logits_match_the_decode_path(models):
    """The last position's logits of one prefill equal those of the
    decode path run over the same prompt (the port against itself; the
    decode path is held to the reference in tests/test_torch_serve.py)."""
    m = models["stablelm-3b"]
    tc, tp = m["tc"], model_params_from_jax(m["params"], "cpu")
    prompt = torch.tensor(m["batch"]["tokens"][:, :12])
    cache = t_decode.init_cache(tc, B, 12, torch.float32)
    for i in range(12):
        logits, cache = t_decode.decode_step(tc, tp, prompt[:, i:i + 1],
                                             cache, i)
    got = t_tf.prefill_logits(tc, tp, {"tokens": prompt})
    close(got, logits, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# train step, input specs, the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_three_train_steps_match_reference(models, optimizer):
    """Three steps of the train step, microbatch 2 and the grad clip at
    1.0, from the reference's params (converted copies: the port's step
    updates its trees in place)."""
    m = models["qwen1.5-4b"]
    kw = dict(optimizer=optimizer, lr=1e-3, microbatch=2)
    jstep, jopt = j_steps.make_train_step(m["jc"], JTrainConfig(**kw))
    jstep = jax.jit(jstep)
    tstep, topt = t_steps.make_train_step(m["tc"], TrainConfig(**kw))
    jp = m["params"]
    js = jopt.init(jp)
    tp = model_params_from_jax(jp, "cpu")
    ts = topt.init(tp)
    for i in range(3):
        b = batch_np(m["jc"], 100 + i)
        jp, js, jm = jstep(jp, js, b)
        tp, ts, tm = tstep(tp, ts, to_t(b))
        close(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, atol=0)
        close(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5,
              atol=0)
    lr = kw["lr"]
    for g, w in zip(tree_leaves(tree_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jp)):
        if optimizer == "sgd":
            close(g, w, rtol=1e-5, atol=1e-7)
        else:
            close(g, w, rtol=0, atol=0.05 * lr)
    if optimizer == "adamw":
        assert int(ts["count"]) == int(js["count"]) == 3
        for key in ("mu", "nu"):
            for g, w in zip(tree_leaves(tree_to_numpy(ts[key])),
                            jax.tree_util.tree_leaves(js[key])):
                close(g, w, rtol=0, atol=1e-3 * float(np.abs(w).max()))
    else:
        for g, w in zip(tree_leaves(tree_to_numpy(ts)),
                        jax.tree_util.tree_leaves(js)):
            close(g, w, rtol=1e-4, atol=1e-8)


def test_no_clip_reports_a_zero_norm(models):
    m = models["stablelm-3b"]
    step, opt = t_steps.make_train_step(
        m["tc"], TrainConfig(grad_clip=0.0, optimizer="sgd"))
    tp = model_params_from_jax(m["params"], "cpu")
    _, _, metrics = step(tp, opt.init(tp), to_t(m["batch"]))
    assert float(metrics["grad_norm"]) == 0.0


@pytest.mark.parametrize("arch", ["stablelm-3b", "internvl2-2b",
                                  "whisper-large-v3"])
def test_input_specs_match_reference(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    assert INPUT_SHAPES == J_SHAPES or {
        k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for shape in INPUT_SHAPES.values():
        want = j_specs.train_inputs(jc, J_SHAPES[shape.name])
        got = t_specs.train_inputs(tc, shape)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    small = {"tokens": t_specs.TensorSpec((2, 3), torch.int32),
             "frames": t_specs.TensorSpec((2, 4), torch.bfloat16)}
    jsmall = {"tokens": jax.ShapeDtypeStruct((2, 3), jnp.int32),
              "frames": jax.ShapeDtypeStruct((2, 4), jnp.bfloat16)}
    got, want = t_specs.concrete_like(small), j_specs.concrete_like(jsmall)
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
        assert got[k].dtype == small[k].dtype


@pytest.mark.parametrize("arch", ["stablelm-3b", "internvl2-2b",
                                  "whisper-large-v3"])
def test_synth_batch_matches_reference(arch):
    cfg_j, cfg_t = j_get_config(arch).reduced(), get_config(arch).reduced()
    want = j_train.synth_batch(cfg_j, 2, 6, np.random.default_rng(0))
    got = t_train.synth_batch(cfg_t, 2, 6, np.random.default_rng(0))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_shardctx_is_a_single_device_no_op():
    x = torch.zeros(2, 3)
    assert shardctx.shard(x, "batch", None) is x
    assert shardctx.current_rules() == (None, None)
    with shardctx.use_rules("mesh", {"batch": "data"}):
        assert shardctx.current_rules() == ({"batch": "data"}, "mesh")
        assert shardctx.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank"):
            shardctx.shard(x, "batch")
    assert shardctx.current_rules() == (None, None)


def test_train_cli_runs_and_checkpoints(tmp_path):
    """``main(argv)`` in-process on synthetic-mlp on the CPU, as the
    reference's CLI runs it: its lines, finite losses,
    the tokens of the reference's batches, a checkpoint that loads."""
    path = str(tmp_path / "ck.npz")
    argv = ["--arch", "synthetic-mlp", "--steps", "3", "--batch", "2",
            "--seq", "16", "--checkpoint", path]
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = t_train.run(argv + ["--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert lines[3] == f"saved {path}"
    assert len(res.losses) == 3 and np.all(np.isfinite(res.losses))
    # the first loss is near ln V for random weights
    assert abs(res.losses[0] - np.log(res.cfg.vocab)) < 0.5
    like = res.params
    back, step = load_checkpoint(path, like)
    assert step == 3
    for a, b in zip(tree_leaves(back), tree_leaves(res.params)):
        assert torch.equal(a, b)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert j_train.main(argv[:-2]) == 0
    assert [ln.split()[:2] for ln in buf.getvalue().splitlines()] == [
        ln.split()[:2] for ln in lines[:3]]
    assert t_train.main(argv[:-2] + ["--steps", "1", "--device",
                                     "cpu"]) == 0


def test_train_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--arch", "synthetic-mlp", "--steps", "1"])
