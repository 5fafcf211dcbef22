"""The port's model and local updates against the JAX reference.

Same parameters and batches through both. Tolerances: logits and loss
rtol 1e-5 / atol 1e-6 (float32 matmuls and logsumexp summed in another
order); per-client uploads and loss0 after several SGD steps atol 1e-5;
accuracy and the flatten order exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client_updates as j_cu
from repro.core import mlp as j_mlp
from repro.core import tra as j_tra
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import client_updates as t_cu
from repro_torch.core import mlp as t_mlp
from repro_torch.core import tra as t_tra

HYPER = {"lr": 0.1, "lipschitz": 1.0}


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v)
            for k, v in j_mlp.mlp_init(jax.random.PRNGKey(3)).items()}


def _batch(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (60,)).astype(np.float32)
    y = rng.integers(0, 10, shape).astype(np.int32)
    return x, y


def test_init_leaf_order_and_values(params):
    t = t_mlp.mlp_init(prng.PRNGKey(3))
    assert list(t) == sorted(params) == ["b1", "b2", "w1", "w2"]
    for k in params:
        assert tuple(t[k].shape) == params[k].shape
        # erfinv differs by a few ulps between the frameworks
        np.testing.assert_allclose(t[k].numpy(), params[k], rtol=1e-5,
                                   atol=1e-7)


def test_logits_loss_accuracy(params):
    x, y = _batch(0, (257,))
    w = (np.random.default_rng(1).random(257) > 0.2).astype(np.float32)
    tp = params_from_jax(params, "cpu")
    xt, yt, wt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w)
    np.testing.assert_allclose(
        t_mlp.mlp_logits(tp, xt).numpy(),
        np.asarray(j_mlp.mlp_logits(params, x)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(t_mlp.mlp_loss(tp, xt, yt)),
        float(j_mlp.mlp_loss(params, x, y)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(t_mlp.mlp_weighted_loss(tp, xt, yt, wt)),
        float(j_mlp.mlp_weighted_loss(params, x, y, w)), rtol=1e-5,
        atol=1e-6)
    ta = [float(v) for v in t_mlp.mlp_accuracy(tp, xt, yt, wt)]
    ja = [float(v) for v in j_mlp.mlp_accuracy(params, x, y, w)]
    assert ta == ja


@pytest.mark.parametrize("algo", ["fedavg", "qfedavg"])
def test_local_updates_over_cohort(params, algo):
    C, steps, bs = 4, 5, 16
    X, Y = _batch(2, (C, steps, bs))
    j_fn = {"fedavg": j_cu.fedavg_local, "qfedavg": j_cu.qfedavg_local}[algo]
    j_up, j_aux = jax.vmap(lambda x, y: j_fn(params, x, y, HYPER))(
        jnp.asarray(X), jnp.asarray(Y))
    t_up, t_aux = torch.func.vmap(
        lambda p, x, y: t_cu.LOCAL_FNS[algo](p, x, y, HYPER),
        in_dims=(None, 0, 0))(params_from_jax(params, "cpu"),
                              torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(t_aux["loss0"].numpy(),
                               np.asarray(j_aux["loss0"]), atol=1e-5)
    j_flat = np.asarray(j_tra.flatten_clients(j_up, C))
    t_flat = t_tra.flatten_clients(t_up, C).numpy()
    assert t_flat.shape == j_flat.shape == (C, 9098)
    np.testing.assert_allclose(t_flat, j_flat, atol=1e-5)


@pytest.mark.parametrize("loss_rate", [0.0, 0.3])
def test_simulate_uploads_matches_reference(loss_rate):
    """Bitwise: the same threefry draws give the same packet masks."""
    rng = np.random.default_rng(4)
    upd = rng.normal(size=(5, 700)).astype(np.float32)
    suff = (rng.random(5) > 0.5).astype(np.float32)
    j = j_tra.simulate_uploads(jax.random.PRNGKey(9), jnp.asarray(upd),
                               jnp.asarray(suff), loss_rate,
                               packet_floats=64)
    t = t_tra.simulate_uploads(prng.PRNGKey(9), torch.from_numpy(upd),
                               torch.from_numpy(suff), loss_rate,
                               packet_floats=64)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_flatten_unflatten_order(params):
    C = 3
    stacked = {k: np.stack([v + i for i in range(C)])
               for k, v in params.items()}
    j = np.asarray(j_tra.flatten_clients(stacked, C))
    t = t_tra.flatten_clients(params_from_jax(stacked, "cpu"), C).numpy()
    np.testing.assert_array_equal(t, j)
    tp = params_from_jax(params, "cpu")
    back = t_tra.unflatten_like(torch.tensor(j[1]), tp)
    jb = j_tra.unflatten_like(jnp.asarray(j[1]), params)
    assert list(back) == list(tp)
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jb[k]))
