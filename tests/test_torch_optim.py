"""The port's optimizers (``repro_torch.optim.optimizers``) against the
JAX reference's (``repro.optim.optimizers``) on a seeded tree.

Inputs come from numpy seeds (a nested dict of f32 leaves shaped like a
model's, one of them bf16). Tolerances:
- SGD and the clip's scaled leaves: bitwise (one f32 product each);
- AdamW's updates and moments over three steps: rtol 1e-6 / atol 1e-12
  (XLA may fuse the moment updates' multiply-adds, torch does not; a
  last-ulp difference in a moment moves an update by about as much);
- the global norm: rtol 1e-6 (the sums add in another order);
- the cosine schedule: rtol 1e-6 / atol 1e-12 (XLA's and torch's cos);
- ``apply_updates``: bitwise.
The in-place update (``update_``) equals the functional one bitwise.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import optimizers as j_opt
from repro_torch.convert import (model_params_from_jax, opt_state_from_jax,
                                 tree_to_numpy)
from repro_torch.optim import optimizers as t_opt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are tiny, and the suite's workers
    share the cores: one torch thread, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_tree(seed, scale=1.0):
    """A model-shaped tree of jnp arrays (the reference's functions
    see JAX arrays, never numpy's, whose bf16 arithmetic promotes)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    tree = {"embed": f(16, 8), "final_norm": f(8),
            "blocks": {"attn": {"wq": f(2, 8, 2, 4), "wo": f(2, 2, 4, 8)},
                       "norm1": f(2, 8)},
            "head": f(8, 16).astype(ml_dtypes.bfloat16)}
    return jax.tree.map(jnp.asarray, tree)


def to_t(tree):
    return model_params_from_jax(tree, "cpu")


def assert_tree(got, want, rtol=0.0, atol=0.0):
    got, want = tree_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if rtol == 0.0 and atol == 0.0:
            np.testing.assert_array_equal(g.astype(np.float32),
                                          w.astype(np.float32))
        else:
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32),
                                       rtol=rtol, atol=atol)


def test_tree_order_is_jax_tree_util_order():
    tree = seeded_tree(0)
    paths = ["/".join(p) for p, _ in t_opt.tree_paths(tree)]
    want = ["/".join(k.key for k in kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths == want
    leaves = t_opt.tree_leaves(to_t(tree))
    back = t_opt.tree_unflatten(tree, leaves)
    assert_tree(back, tree)
    with pytest.raises(ValueError, match="more leaves"):
        t_opt.tree_unflatten(tree, leaves + leaves[:1])


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip(max_norm):
    g = seeded_tree(1)
    jg, jn = j_opt.clip_by_global_norm(g, max_norm)
    tg, tn = t_opt.clip_by_global_norm(to_t(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(t_opt.global_norm(to_t(g))),
                               float(j_opt.global_norm(g)), rtol=1e-6)
    # the same scale: bitwise when the norms agree, else within 1e-6
    same = float(tn) == float(jn)
    assert_tree(tg, jg, *(() if same else (1e-6, 0.0)))


def _run_opt(name, kw, steps=3):
    """(jax updates, states), (port updates, states) over ``steps``
    steps from the same params and gradients."""
    jo = getattr(j_opt, name)(**kw)
    to = getattr(t_opt, name)(**kw)
    params = seeded_tree(2)
    js, ts = jo.init(params), to.init(to_t(params))
    out = []
    for i in range(steps):
        grads = seeded_tree(10 + i, scale=1e-3)
        ju, js = jo.update(grads, js, params)
        tu, ts = to.update(to_t(grads), ts, to_t(params))
        out.append(((ju, js), (tu, ts)))
    return out


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    for (ju, js), (tu, ts) in _run_opt("sgd", dict(lr=0.05,
                                                   momentum=momentum)):
        assert_tree(tu, ju)
        if momentum == 0.0:
            assert js == () and ts == ()
        else:
            assert_tree(ts, js)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_matches_reference(wd):
    for (ju, js), (tu, ts) in _run_opt("adamw", dict(lr=3e-4,
                                                     weight_decay=wd)):
        assert_tree(tu, ju, rtol=1e-6, atol=1e-12)
        assert_tree(ts["mu"], js["mu"], rtol=1e-6, atol=1e-12)
        assert_tree(ts["nu"], js["nu"], rtol=1e-6, atol=1e-12)
        assert ts["count"].dtype == torch.int32
        assert int(ts["count"]) == int(js["count"])


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.05, momentum=0.0)),
    ("sgd", dict(lr=0.05, momentum=0.9)),
    ("adamw", dict(lr=3e-4, weight_decay=0.01))])
def test_in_place_update_equals_functional(name, kw):
    """``update_`` writes the functional step's values into the given
    params and state, bitwise, over three steps."""
    opt = getattr(t_opt, name)(**kw)
    p_fun = to_t(seeded_tree(3))
    p_inp = to_t(seeded_tree(3))
    s_fun, s_inp = opt.init(p_fun), opt.init(p_inp)
    for i in range(3):
        grads = to_t(seeded_tree(20 + i, scale=1e-2))
        u, s_fun = opt.update(grads, s_fun, p_fun)
        p_fun = t_opt.apply_updates(p_fun, u)
        ids = [id(t) for t in t_opt.tree_leaves(p_inp)]
        p_inp, s_inp = opt.update_(grads, s_inp, p_inp)
        assert [id(t) for t in t_opt.tree_leaves(p_inp)] == ids
        assert_tree(p_inp, tree_to_numpy(p_fun))
        if s_fun != ():
            assert_tree(s_inp, tree_to_numpy(s_fun))


def test_apply_updates_and_make_optimizer():
    p, u = seeded_tree(4), seeded_tree(5, scale=1e-3)
    u = jax.tree.map(lambda x: x.astype(jnp.float32), u)
    assert_tree(t_opt.apply_updates(to_t(p), to_t(u)),
                j_opt.apply_updates(p, u))
    for name in ("sgd", "adamw"):
        opt = t_opt.make_optimizer(name, 1e-3)
        assert isinstance(opt, t_opt.Optimizer)
    with pytest.raises(ValueError):
        t_opt.make_optimizer("lion", 1e-3)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5)])
def test_cosine_schedule_matches_reference(warmup, total):
    j_lr = j_opt.cosine_schedule(3e-4, warmup, total)
    t_lr = t_opt.cosine_schedule(3e-4, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(float(t_lr(step)), float(j_lr(step)),
                                   rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(
        t_lr(torch.arange(total + 3)).numpy(),
        np.asarray(j_lr(jnp.arange(total + 3))), rtol=1e-6, atol=1e-12)


def test_opt_state_converts_from_reference():
    """The reference's SGD and AdamW states carry over (leaf dtypes and
    the count kept), and a port step from a converted state equals the
    reference's next step within the AdamW tolerance."""
    params = seeded_tree(6)
    for name, kw in (("sgd", dict(lr=0.05, momentum=0.0)),
                     ("sgd", dict(lr=0.05, momentum=0.9)),
                     ("adamw", dict(lr=3e-4))):
        jo, to = getattr(j_opt, name)(**kw), getattr(t_opt, name)(**kw)
        js = jo.init(params)
        _, js = jo.update(seeded_tree(7, 1e-3), js, params)
        ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
        if js == ():
            assert ts == ()
            continue
        assert_tree(ts, js)
        g = seeded_tree(8, 1e-3)
        ju, js2 = jo.update(g, js, params)
        tu, ts2 = to.update(to_t(g), ts, to_t(params))
        assert_tree(tu, ju, rtol=1e-6, atol=1e-12)
        assert_tree(ts2, js2, rtol=1e-6, atol=1e-12)
