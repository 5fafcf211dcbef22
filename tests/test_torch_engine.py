"""The port's round engine and server against the JAX reference.

Both packages run the same configuration from the same initial weights
(``convert.params_from_jax``) on the same data and networks. The PRNG,
selection, batch indices and loss masks are bitwise, so cohorts must be
equal every round. Float work (matmuls, logsumexp, the uplink einsum)
sums in another order, so: losses rtol 1e-5, final params rtol 1e-4 /
atol 1e-5, fairness fields 1e-6. Runs stay at 5 rounds: past about a
dozen rounds a ReLU unit sitting within 1e-7 of zero flips under such
1-ulp differences and the trajectories part at the 1e-4 level (a 1e-7
perturbation of the port alone does the same), which is sensitivity of
the dynamics, not a fault.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.core import selection as j_sel
from repro.core.server import FederatedServer as JServer
from repro.core.server import FLConfig as JConfig
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.network.trace import ClientNetworks as JNets
from repro.network.trace import sample_networks as j_sample_networks
from repro_torch import prng
from repro_torch.convert import ef_mem_from_numpy, params_from_jax
from repro_torch.core import selection as t_sel
from repro_torch.core.engine import RoundScanEngine
from repro_torch.core.selection import SelectionConfig
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.network.packets import n_packets
from repro_torch.network.trace import ClientNetworks as TNets
from repro_torch.network.trace import sample_networks as t_sample_networks

N_CLIENTS = 20
ROUNDS = 5


@pytest.fixture(scope="module")
def small():
    """tests/test_engine.py's setup, in both packages."""
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    loss = np.full(N_CLIENTS, 0.05)
    return (j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), JNets(speeds, loss),
            t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), TNets(speeds, loss))


@pytest.fixture(scope="module")
def quickstart():
    """examples/quickstart.py's data and networks, in both packages."""
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    jd = j_generate(jr, n_clients=30, alpha=1.0, beta=1.0)
    td = t_generate(tr, n_clients=30, alpha=1.0, beta=1.0)
    return jd, j_sample_networks(jr, 30), td, t_sample_networks(tr, 30)


def _configs(tra, **kw):
    jc = JConfig(n_rounds=ROUNDS, tra=JTRA(**tra), eval_every=100, **kw)
    tc = TConfig(n_rounds=ROUNDS, tra=TTRA(**tra), eval_every=100, **kw)
    return jc, tc


def _vec(params):
    return np.concatenate([np.asarray(params[k]).ravel()
                           for k in sorted(params)])


def _gumbel_tie(seed, t, n_draws, n_clients, a, b):
    """True when clients a and b's Gumbel keys at round t sit within one
    ulp of each other in either framework, i.e. a cohort swap between
    them is float noise in -log(-log u), not a fault."""
    u = prng.uniform(prng.fold_in(prng.PRNGKey(seed), t), (n_draws,),
                     minval=1e-12)[:n_clients]
    g_t = (-torch.log(-torch.log(u))).numpy()
    g_j = np.asarray(-jnp.log(-jnp.log(jnp.asarray(u.numpy()))))
    return any(abs(g[a] - g[b]) <= np.spacing(np.float32(abs(g[a])))
               for g in (g_t, g_j))


def _assert_same_cohorts(j_ids, t_ids, cfg, n_clients, P):
    n_draws = (n_clients + min(cfg.clients_per_round, n_clients)
               * cfg.local_steps * cfg.batch_size
               + min(cfg.clients_per_round, n_clients) * P)
    for t, (a, b) in enumerate(zip(j_ids, t_ids)):
        if np.array_equal(a, b):
            continue
        i = int(np.flatnonzero(a != b)[0])
        tie = _gumbel_tie(cfg.seed, t, n_draws, n_clients, a[i], b[i])
        raise AssertionError(
            f"round {t}: cohorts differ ({a} vs {b}); "
            + ("a 1-ulp tie in -log(-log u), not a port fault" if tie
               else "no ulp tie explains it: a port fault"))


def _run_both(jdata, jnets, tdata, tnets, jc, tc):
    js = JServer(jc, jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    jstate, jlogs = js.engine.run_block(js.engine.init_state(js.params), 0,
                                        ROUNDS)
    ts = TServer(tc, tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    tstate, tlogs = ts.engine.run_block(ts.engine.init_state(ts.params), 0,
                                        ROUNDS)
    P = n_packets(_vec(init).size, tc.tra.packet_floats)
    _assert_same_cohorts(jlogs["ids"], tlogs["ids"], tc, tdata.n_clients, P)
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    np.testing.assert_allclose(_vec(tstate.params), _vec(jstate.params),
                               rtol=1e-4, atol=1e-5)
    if tc.error_feedback:
        np.testing.assert_allclose(tstate.ef_mem.numpy(),
                                   np.asarray(jstate.ef_mem), rtol=1e-4,
                                   atol=1e-5)
    # the servers' own run(): same rounds, same final report
    jh, th = js.run(), ts.run()
    np.testing.assert_allclose([h.train_loss for h in th],
                               [h.train_loss for h in jh], rtol=1e-5)
    np.testing.assert_allclose(_vec(ts.params), _vec(jstate.params),
                               rtol=1e-4, atol=1e-5)
    jr = jh[-1].report.as_dict()
    tr = th[-1].report.as_dict()
    for k in jr:
        assert abs(tr[k] - jr[k]) <= 1e-6 * max(1.0, abs(jr[k])), k
    return tlogs


@pytest.mark.parametrize("algo", ["fedavg", "qfedavg"])
@pytest.mark.parametrize("tra,ef", [
    (dict(enabled=False), False),
    (dict(enabled=True, loss_rate=0.2), False),
    (dict(enabled=True, loss_rate=0.2), True),
    (dict(enabled=True, per_client_loss=True, debias="per_client_rate"),
     True)])
def test_rounds_match_reference(small, algo, tra, ef):
    jc, tc = _configs(tra, algo=algo, clients_per_round=8, local_steps=4,
                      batch_size=16, error_feedback=ef)
    logs = _run_both(*small, jc, tc)
    assert logs["ids"].shape == (ROUNDS, 8)


@pytest.mark.parametrize("selection", ["all", "ratio"])
def test_quickstart_round_matches_reference(quickstart, selection):
    """The quickstart's shape: N=30, C=10, 10 local steps of 32, q-FedAvg
    with TRA at 10% loss (all eligible) or threshold selection at 70%."""
    tra = dict(enabled=selection == "all", loss_rate=0.1)
    jc, tc = _configs(tra, algo="qfedavg", clients_per_round=10,
                      local_steps=10, selection=selection,
                      eligible_ratio=0.7)
    _run_both(*quickstart, jc, tc)


def test_select_from_uniforms_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(6):
        n = int(rng.integers(5, 40))
        u = rng.uniform(1e-12, 1.0, n).astype(np.float32)
        elig = rng.random(n) > 0.5
        for k in (1, n // 2, n):     # k > #eligible: -inf ties decide
            j = np.asarray(j_sel.select_from_uniforms(
                jnp.asarray(u), None, jnp.asarray(elig), k))
            t = t_sel.select_from_uniforms(torch.from_numpy(u), None,
                                           torch.from_numpy(elig), k)
            np.testing.assert_array_equal(t.numpy(), j)


def _port_server(data, nets, **kw):
    cfg = TConfig(n_rounds=ROUNDS, clients_per_round=8, local_steps=4,
                  batch_size=16, algo="qfedavg", error_feedback=True,
                  tra=TTRA(enabled=True, loss_rate=0.2), **kw)
    return TServer(cfg, data, nets, device="cpu")


def test_scan_equals_per_round(small):
    """Blocks cut at evaluation boundaries, per-round calls and one long
    block all run the same step: bit-identical results."""
    _, _, data, nets = small
    runs = [_port_server(data, nets, engine="scan", eval_every=2),
            _port_server(data, nets, engine="per_round", eval_every=2),
            _port_server(data, nets, engine="scan", eval_every=100)]
    for s in runs:
        s.run()
    ref = runs[0]
    for s in runs[1:]:
        np.testing.assert_array_equal(_vec(s.params), _vec(ref.params))
        np.testing.assert_array_equal(s._ef_mem, ref._ef_mem)
        assert [h.train_loss for h in s.history] == \
            [h.train_loss for h in ref.history]
    assert [h.report is not None for h in ref.history] == \
        [False, True, False, True, True]
    assert ref.history[-1].report.as_dict() == \
        runs[1].history[-1].report.as_dict()


def test_default_device_is_the_card(small, monkeypatch):
    _, _, data, nets = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TServer(TConfig(n_rounds=1), data, nets)


@pytest.mark.parametrize("change", [
    dict(sel=SelectionConfig(policy="reputation_aware")),
    dict(sel=SelectionConfig(traced=True))])
def test_unported_configs_raise(small, change):
    """The reference's refusals of a score without its source:
    reputation_aware without the fault model, and the traced policy
    family (which holds the bandwidth score) without the trace draw,
    which the server always passes."""
    _, _, data, nets = small
    cfg = dataclasses.replace(TConfig(n_rounds=1), **change)
    if cfg.sel.traced:
        with pytest.raises(ValueError, match="upload_mbps"):
            RoundScanEngine(cfg, data, np.ones(N_CLIENTS),
                            np.ones(N_CLIENTS, bool), device="cpu")
        TServer(cfg, data, nets, device="cpu")
    else:
        with pytest.raises(ValueError, match="reputation_aware"):
            TServer(cfg, data, nets, device="cpu")


def test_convert_round_trip():
    rng = np.random.default_rng(1)
    tree = {"w2": rng.normal(size=(3, 2)), "b1": rng.normal(size=4)}
    p = params_from_jax(tree, "cpu")
    assert list(p) == ["b1", "w2"] and p["w2"].dtype == torch.float32
    np.testing.assert_array_equal(p["w2"].numpy(),
                                  tree["w2"].astype(np.float32))
    ef = ef_mem_from_numpy(rng.normal(size=(5, 7)), "cpu")
    assert ef.shape == (5, 7) and ef.dtype == torch.float32
