"""The paper's personalization and baseline algorithms (pFedMe,
Per-FedAvg, AFL, SCAFFOLD) in the port against the JAX reference.

Both packages get the same seeded numpy inputs and the reference's
weights (``convert.params_from_jax``). The local and personalize
functions are held at the paper's width (D = 9,098): uploads and
personalized params within rtol 1e-5 / atol 1e-6, ``loss0`` within
1e-6. The server rounds reuse ``tests/test_torch_engine.py``'s setup
for 5 rounds: cohorts bitwise, losses rtol 1e-5, params and the
algorithms' carries (SCAFFOLD's variates, AFL's weights, the EF
memory) rtol 1e-4 / atol 1e-5, the global and personalized fairness
reports within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.core import client_updates as j_cu
from repro.core.mlp import mlp_init as j_mlp_init
from repro.core.server import FederatedServer as JServer
from repro.core.server import FLConfig as JConfig
from repro.core.server import run_grid as j_run_grid
from repro.core.tra import TRAConfig as JTRA
from repro.netsim.config import NetSimConfig as JNetSim
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.core import client_updates as t_cu
from repro_torch.core.engine import ENGINE_ALGOS
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.server import run_grid as t_run_grid
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.network.packets import n_packets
from tests.test_torch_engine import (_assert_same_cohorts, _vec,  # noqa: F401
                                     small)

ROUNDS = 5
D_MODEL = 9098
HYPER = TConfig().hyper()
ALGOS = ("pfedme", "perfedavg", "afl", "scaffold")
PERSONALIZED = ("pfedme", "perfedavg")


def _init(seed=0):
    return {k: np.asarray(v)
            for k, v in j_mlp_init(jax.random.PRNGKey(seed)).items()}


def _batches(seed, steps, bs=16, n_clients=None):
    rng = np.random.default_rng(seed)
    lead = (steps, bs) if n_clients is None else (n_clients, steps, bs)
    X = rng.normal(size=(*lead, 60)).astype(np.float32)
    Y = rng.integers(0, 10, size=lead).astype(np.int32)
    return X, Y


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).ravel()
                           for k in sorted(tree)])


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_flat({k: v.numpy() for k, v in t.items()}),
                               _flat(j), rtol=rtol, atol=atol)


def test_local_fns_and_engine_algos_cover_the_reference():
    assert set(ENGINE_ALGOS) == {"fedavg", "qfedavg", "pfedme", "perfedavg",
                                 "afl", "scaffold"}
    assert set(t_cu.LOCAL_FNS) == set(j_cu.LOCAL_FNS)
    assert t_cu.LOCAL_FNS["afl"] is t_cu.fedavg_local
    assert not hasattr(t_cu, "_not_ported")


@pytest.mark.parametrize("name,steps", [
    ("pfedme_local", 10), ("pfedme_local", 11), ("perfedavg_local", 10),
    ("perfedavg_local", 7), ("fedavg_local", 10)])
def test_local_fn_matches_reference(name, steps):
    """pFedMe drops the steps past R * K; Per-FedAvg drops an odd last
    batch; AFL trains as FedAvg."""
    init = _init()
    X, Y = _batches(steps, steps)
    jnew, jaux = getattr(j_cu, name)(init, jnp.asarray(X), jnp.asarray(Y),
                                     HYPER)
    tnew, taux = getattr(t_cu, name)(params_from_jax(init, "cpu"),
                                     torch.from_numpy(X),
                                     torch.from_numpy(Y), HYPER)
    assert list(tnew) == ["b1", "b2", "w1", "w2"]
    _close(tnew, jnew)
    assert abs(float(taux["loss0"]) - float(jaux["loss0"])) <= 1e-6


@pytest.mark.parametrize("name,steps", [("pfedme_personalize", 5),
                                        ("perfedavg_personalize", 5)])
def test_personalize_matches_reference(name, steps):
    init = _init(1)
    X, Y = _batches(steps + 100, steps)
    jp = getattr(j_cu, name)(init, jnp.asarray(X), jnp.asarray(Y), HYPER)
    tp = getattr(t_cu, name)(params_from_jax(init, "cpu"),
                             torch.from_numpy(X), torch.from_numpy(Y), HYPER)
    _close(tp, jp)


@pytest.mark.parametrize("steps", [4, 10])
def test_scaffold_local_matches_reference(steps):
    """Non-zero server and client variates; dw = w+ - w and dc as the
    reference computes them."""
    init = _init(2)
    rng = np.random.default_rng(steps)
    cg = {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in init.items()}
    ci = {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in init.items()}
    X, Y = _batches(steps + 200, steps)
    jup, jaux = j_cu.scaffold_local(init, jnp.asarray(X), jnp.asarray(Y),
                                    cg, ci, HYPER)
    tup, taux = t_cu.scaffold_local(
        params_from_jax(init, "cpu"), torch.from_numpy(X),
        torch.from_numpy(Y), params_from_jax(cg, "cpu"),
        params_from_jax(ci, "cpu"), HYPER)
    _close(tup["dw"], jup["dw"])
    _close(tup["dc"], jup["dc"])
    assert abs(float(taux["loss0"]) - float(jaux["loss0"])) <= 1e-6


def test_vmapped_local_fns_match_reference():
    """The engine vmaps the clients over the cohort."""
    init = _init(3)
    X, Y = _batches(5, 4, n_clients=3)
    for name in ("pfedme_local", "perfedavg_local"):
        jnew, _ = jax.vmap(getattr(j_cu, name), in_axes=(None, 0, 0, None))(
            init, jnp.asarray(X), jnp.asarray(Y), HYPER)
        fn = getattr(t_cu, name)
        tnew, _ = torch.func.vmap(lambda p, x, y: fn(p, x, y, HYPER),
                                  in_dims=(None, 0, 0))(
            params_from_jax(init, "cpu"), torch.from_numpy(X),
            torch.from_numpy(Y))
        _close(tnew, jnew)


# ---------------------------------------------------------------------------
# server rounds
# ---------------------------------------------------------------------------
def _configs(algo, tra, ef, netsim=None, **kw):
    common = dict(algo=algo, n_rounds=ROUNDS, clients_per_round=8,
                  local_steps=4, batch_size=16, pfedme_K=2,
                  error_feedback=ef, eval_every=100, **kw)
    jc = JConfig(tra=JTRA(**tra), netsim=JNetSim(**(netsim or {})), **common)
    tc = TConfig(tra=TTRA(**tra), netsim=TNetSim(**(netsim or {})), **common)
    return jc, tc


def _reports_close(t, j):
    jd, td = j.as_dict(), t.as_dict()
    for k in jd:
        assert abs(td[k] - jd[k]) <= 1e-6 * max(1.0, abs(jd[k])), k


def _states_close(t, j, algo, ef):
    np.testing.assert_allclose(_vec(t.params), _vec(j.params), rtol=1e-4,
                               atol=1e-5)
    names = ["lam"] + (["c_global", "c_i"] if algo == "scaffold" else []) \
        + (["ef_mem"] if ef else [])
    for name in names:
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if algo != "scaffold":
        assert t.c_global.shape == t.c_i.shape == (0,)


def _run_both(jdata, jnets, tdata, tnets, jc, tc):
    """ROUNDS rounds from the same weights in one block, then the
    servers' final evaluation as ``run`` makes it."""
    js = JServer(jc, jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    js._state, jlogs = js.engine.run_block(js._state, 0, ROUNDS)
    ts = TServer(tc, tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    ts._state, tlogs = ts.engine.run_block(ts._state, 0, ROUNDS)
    up = 2 * D_MODEL if tc.algo == "scaffold" else D_MODEL
    _assert_same_cohorts(jlogs["ids"], tlogs["ids"], tc, tdata.n_clients,
                         n_packets(up, tc.tra.packet_floats))
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    _states_close(ts._state, js._state, tc.algo, tc.error_feedback)
    _reports_close(ts.evaluate(), js.evaluate())
    if tc.algo in PERSONALIZED:
        _reports_close(ts.evaluate_personalized(),
                       js.evaluate_personalized())
    return ts, js


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("tra,ef", [
    (dict(enabled=False), False),
    (dict(enabled=True, loss_rate=0.2), False),
    (dict(enabled=True, loss_rate=0.2), True)],
    ids=["tra_off", "tra20", "tra20_ef"])
def test_rounds_match_reference(small, algo, tra, ef):
    jc, tc = _configs(algo, tra, ef)
    ts, _ = _run_both(*small, jc, tc)
    st = ts._state
    D_up = 2 * D_MODEL if algo == "scaffold" else D_MODEL
    assert st.ef_mem.shape == ((small[2].n_clients, D_up) if ef else (0,))
    if algo == "afl":
        assert abs(float(st.lam.sum()) - 1.0) < 1e-6


def test_scaffold_downlink_stale_matches_reference(small):
    """SCAFFOLD under a 30% Gilbert–Elliott downlink with the stale
    fallback: the broadcast is the model (D floats), the upload 2·D."""
    jc, tc = _configs("scaffold", dict(enabled=True, loss_rate=0.2), True,
                      netsim=dict(down_channel="gilbert_elliott",
                                  down_loss=0.3, down_fallback="stale"))
    ts, js = _run_both(*small, jc, tc)
    np.testing.assert_allclose(ts._state.stale_model.numpy(),
                               np.asarray(js._state.stale_model), rtol=1e-4,
                               atol=1e-5)
    assert ts._state.stale_model.shape == (small[2].n_clients, D_MODEL)
    np.testing.assert_array_equal(ts._state.net.down.numpy(),
                                  np.asarray(js._state.net.down))


@pytest.mark.parametrize("algo", PERSONALIZED)
def test_run_evaluates_personalized_at_every_boundary(small, algo):
    """``run`` draws the personalization batches from the server's numpy
    generator at each evaluation boundary, in the reference's order, and
    ``run_round`` does the same."""
    jdata, jnets, tdata, tnets = small
    jc, tc = _configs(algo, dict(enabled=True, loss_rate=0.2), False)
    jc.eval_every = tc.eval_every = 2
    js = JServer(jc, jdata, jnets)
    init = params_from_jax({k: np.asarray(v) for k, v in js.params.items()},
                           "cpu")
    jh = js.run()
    ts = TServer(tc, tdata, tnets, device="cpu", init_params=init)
    th = ts.run()
    tc.engine = "per_round"
    tr = TServer(tc, tdata, tnets, device="cpu", init_params=init).run()
    assert [h.personalized is not None for h in th] == \
        [h.personalized is not None for h in jh] == \
        [False, True, False, True, True]
    for j, t, r in zip(jh, th, tr):
        assert t.train_loss == pytest.approx(j.train_loss, rel=1e-5)
        if j.personalized is not None:
            _reports_close(t.report, j.report)
            _reports_close(t.personalized, j.personalized)
            assert r.personalized.as_dict() == t.personalized.as_dict()


def test_pfedme_grid_matches_reference(small):
    """A 3-cell pFedMe TRA grid (loss 0.1 / 0.2 / 0.3) through run_grid,
    as one batched step a round, against the reference's run_grid."""
    jdata, jnets, tdata, tnets = small
    pairs = [_configs("pfedme", dict(enabled=True, loss_rate=r), False)
             for r in (0.1, 0.2, 0.3)]
    jh = j_run_grid([j for j, _ in pairs], jdata, jnets)
    init = params_from_jax(_init(0), "cpu")
    th = t_run_grid([t for _, t in pairs], tdata, tnets, device="cpu",
                    init_params=[init] * 3)
    for j, t in zip(jh, th):
        np.testing.assert_allclose([h.train_loss for h in t],
                                   [h.train_loss for h in j], rtol=1e-5)
        _reports_close(t[-1].report, j[-1].report)


def test_engine_state_from_jax_carries_the_variates(small):
    jdata, jnets, _, _ = small
    jc, _ = _configs("scaffold", dict(enabled=True, loss_rate=0.2), True)
    js = JServer(jc, jdata, jnets)
    jst, _ = js.engine.run_block(js._state, 0, 1)
    t = engine_state_from_jax(jst, "cpu")
    assert t.c_global.shape == (D_MODEL,)
    assert t.c_i.shape == (jdata.n_clients, D_MODEL)
    assert t.ef_mem.shape == (jdata.n_clients, 2 * D_MODEL)
    np.testing.assert_array_equal(t.c_i.numpy(), np.asarray(jst.c_i))
    np.testing.assert_array_equal(t.c_global.numpy(),
                                  np.asarray(jst.c_global))
