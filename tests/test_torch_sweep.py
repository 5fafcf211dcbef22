"""The port's sweep engine and ``run_grid`` against the JAX reference.

A sweep stacks S scenarios and vmaps the single round step over them.
Tolerances:
  * bitwise: cohorts and Gilbert–Elliott channel states (they depend on
    the threefry uniforms alone), and the staged data and eligibility;
  * against the reference's sweep, 5 rounds from the reference's
    weights: losses rtol 1e-5, params rtol 1e-4 / atol 1e-5 (matmuls
    sum in another order; tests/test_torch_engine.py says why runs stop
    at 5);
  * against the port's own single runs: losses and params rtol 1e-6
    (under vmap the cohort's SGD is one batched GEMM, which may sum in
    another order than C alone);
  * ``run_grid`` reports against the reference's at 1e-6.
"""
import dataclasses

import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.core.server import FLConfig as JConfig
from repro.core.server import run_grid as j_run_grid
from repro.core.sweep import SweepEngine as JSweep
from repro.core.sweep import scenario_from_config as j_scenario
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.data.synthetic import stage_scenarios_on_device as j_stage
from repro.netsim import NetSimConfig as JNetSim
from repro.network import trace as j_trace
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import _static_key, static_signature
from repro_torch.core.mlp import mlp_init
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.server import run_grid as t_run_grid
from repro_torch.core.sweep import SweepEngine as TSweep
from repro_torch.core.sweep import scenario_from_config as t_scenario
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.data.synthetic import stage_scenarios_on_device as t_stage
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.network import trace as t_trace

N_CLIENTS = 20
ROUNDS = 5


@pytest.fixture(scope="module")
def inputs():
    """tests/test_sweep.py's data and networks, in both packages, plus a
    second, more heterogeneous dataset draw."""
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    loss = np.full(N_CLIENTS, 0.05)
    return dict(
        jdata=j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                         alpha=0.5, beta=0.5),
        jhet=j_generate(np.random.default_rng(1), n_clients=N_CLIENTS,
                        alpha=2.0, beta=2.0),
        jnets=j_trace.ClientNetworks(speeds, loss),
        tdata=t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                         alpha=0.5, beta=0.5),
        thet=t_generate(np.random.default_rng(1), n_clients=N_CLIENTS,
                        alpha=2.0, beta=2.0),
        tnets=t_trace.ClientNetworks(speeds, loss))


def _grid(algo="fedavg", channel="gilbert_elliott", ef=False, bw=False,
          deadline=False, seeds=(0, 1), rates=(0.1, 0.3),
          bursts=(2.0, 8.0), **kw):
    """The same seed x rate x burst grid in both packages."""
    common = dict(algo=algo, n_rounds=ROUNDS, clients_per_round=8,
                  local_steps=2, batch_size=8, error_feedback=ef,
                  eval_every=100)
    common.update(kw)
    out = []
    for Cfg, Tra, Net in ((JConfig, JTRA, JNetSim),
                          (TConfig, TTRA, TNetSim)):
        out.append([Cfg(seed=s, tra=Tra(enabled=True, loss_rate=r),
                        netsim=Net(channel=channel, burst_len=b,
                                   bw_ar1=bw, bw_rho=0.7,
                                   deadline=deadline, deadline_s=0.05),
                        **common)
                    for s in seeds for r in rates for b in bursts])
    return out


def _vec(params, s=None):
    return np.concatenate([np.asarray(params[k] if s is None
                                      else params[k][s]).ravel()
                           for k in sorted(params)])


@pytest.mark.parametrize("algo,channel,ef", [
    ("fedavg", "gilbert_elliott", False),
    ("qfedavg", "gilbert_elliott", True),
    ("qfedavg", "iid", False)])
def test_sweep_matches_reference(inputs, algo, channel, ef):
    """A 2 x 2 x 2 (seed x rate x burst) grid at N = 20."""
    jcfgs, tcfgs = _grid(algo, channel, ef)
    je = JSweep.from_configs(jcfgs, inputs["jdata"], inputs["jnets"])
    j0 = je.init_states()
    init = [{k: np.array(v[s]) for k, v in j0.params.items()}
            for s in range(len(jcfgs))]
    jch0 = np.array(j0.net.channel)
    jst, jlogs = je.run_block(j0, 0, ROUNDS)
    te = TSweep.from_configs(tcfgs, inputs["tdata"], inputs["tnets"],
                             device="cpu")
    t0 = te.init_states([params_from_jax(p, "cpu") for p in init])
    np.testing.assert_array_equal(t0.net.channel.numpy(), jch0)
    tst, tlogs = te.run_block(t0, 0, ROUNDS)
    assert tlogs["ids"].shape == (len(tcfgs), ROUNDS, 8)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_array_equal(tst.net.channel.numpy(),
                                  np.asarray(jst.net.channel))
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    for s in range(len(tcfgs)):
        np.testing.assert_allclose(_vec(tst.params, s),
                                   _vec(jst.params, s), rtol=1e-4,
                                   atol=1e-5)


def _singles(cfgs, data, nets, params):
    """Each cell through its own ``FederatedServer`` engine."""
    out = []
    for c, p in zip(cfgs, params):
        srv = TServer(c, data, nets, device="cpu", init_params=p)
        st, logs = srv.engine.run_block(srv.engine.init_state(srv.params),
                                        0, ROUNDS)
        out.append((st, logs))
    return out


@pytest.mark.parametrize("algo", ["fedavg", "qfedavg"])
@pytest.mark.parametrize("grid", [
    dict(channel="iid", ef=True),
    dict(channel="gilbert_elliott"),
    dict(channel="gilbert_elliott", bw=True, deadline=True)])
def test_sweep_matches_single_runs(inputs, algo, grid):
    """The port's sweep cells against the port's single runs."""
    _, cfgs = _grid(algo, **grid)
    data, nets = inputs["tdata"], inputs["tnets"]
    te = TSweep.from_configs(cfgs, data, nets, device="cpu")
    st, logs = te.run()
    params = [mlp_init(prng.PRNGKey(c.seed)) for c in cfgs]
    for s, (s1, l1) in enumerate(_singles(cfgs, data, nets, params)):
        np.testing.assert_array_equal(logs["ids"][s], l1["ids"])
        np.testing.assert_array_equal(st.net.channel[s].numpy(),
                                      s1.net.channel.numpy())
        np.testing.assert_allclose(logs["loss"][s], l1["loss"], rtol=1e-6)
        np.testing.assert_allclose(_vec(st.params, s), _vec(s1.params),
                                   rtol=1e-6, atol=1e-7)
        if grid.get("deadline"):
            np.testing.assert_array_equal(logs["arrival"][s],
                                          l1["arrival"])
            np.testing.assert_array_equal(st.net.logbw[s].numpy(),
                                          s1.net.logbw.numpy())
    if grid.get("deadline"):
        assert 0 < logs["arrival"].sum() < logs["arrival"].size


def test_sweep_stacked_datasets_match_reference(inputs):
    """Scenarios with their own dataset draws stage a stacked set."""
    jcfgs, tcfgs = _grid("fedavg", "gilbert_elliott", seeds=(0, 1),
                         rates=(0.2,), bursts=(4.0,))
    je = JSweep.from_configs(jcfgs, [inputs["jdata"], inputs["jhet"]],
                             inputs["jnets"])
    j0 = je.init_states()
    init = [{k: np.array(v[s]) for k, v in j0.params.items()}
            for s in range(2)]
    jst, jlogs = je.run_block(j0, 0, ROUNDS)
    te = TSweep.from_configs(tcfgs, [inputs["tdata"], inputs["thet"]],
                             inputs["tnets"], device="cpu")
    assert te.data_batched
    tst, tlogs = te.run_block(
        te.init_states([params_from_jax(p, "cpu") for p in init]), 0,
        ROUNDS)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)


def test_run_grid_matches_reference(inputs):
    """Histories and the fairness reports at evaluation boundaries, and
    the port's grid against the port's own servers."""
    jcfgs, tcfgs = _grid("fedavg", "gilbert_elliott", seeds=(0, 1),
                         rates=(0.2,), bursts=(2.0, 8.0), eval_every=2)
    jh = j_run_grid(jcfgs, inputs["jdata"], inputs["jnets"])
    je = JSweep.from_configs(jcfgs, inputs["jdata"], inputs["jnets"])
    j0 = je.init_states()
    init = [params_from_jax({k: np.array(v[s]) for k, v in
                             j0.params.items()}, "cpu")
            for s in range(len(jcfgs))]
    th = t_run_grid(tcfgs, inputs["tdata"], inputs["tnets"], device="cpu",
                    init_params=init)
    assert len(th) == len(jcfgs)
    for cfg, a, b in zip(tcfgs, jh, th):
        assert [r.round for r in b] == [r.round for r in a]
        assert [r.report is not None for r in b] == \
            [r.report is not None for r in a] == \
            [False, True, False, True, True]
        np.testing.assert_allclose([r.train_loss for r in b],
                                   [r.train_loss for r in a], rtol=1e-5)
        for ra, rb in zip(a, b):
            if ra.report is None:
                continue
            da, db = ra.report.as_dict(), rb.report.as_dict()
            for k in da:
                assert abs(db[k] - da[k]) <= 1e-6 * max(1.0, abs(da[k])), k
    # the port's grid cells against its own single servers
    for cfg, hist, p in zip(tcfgs, th, init):
        srv = TServer(cfg, inputs["tdata"], inputs["tnets"], device="cpu",
                      init_params=p)
        srv.run()
        np.testing.assert_allclose([r.train_loss for r in hist],
                                   [r.train_loss for r in srv.history],
                                   rtol=1e-6)
        np.testing.assert_allclose(hist[-1].report.sample_average,
                                   srv.history[-1].report.sample_average,
                                   rtol=1e-6)


def test_sweep_rejects_mixed_static_grid(inputs):
    data, nets = inputs["tdata"], inputs["tnets"]
    base = _grid(seeds=(0,), rates=(0.2,), bursts=(4.0,))[1][0]

    def mk(**kw):
        return dataclasses.replace(base, **kw)

    for other in (mk(algo="qfedavg"), mk(error_feedback=True),
                  mk(netsim=TNetSim(channel="iid")),
                  mk(netsim=TNetSim(channel="gilbert_elliott",
                                    bw_ar1=True)),
                  mk(netsim=TNetSim(channel="gilbert_elliott",
                                    deadline=True)),
                  mk(local_steps=3)):
        with pytest.raises(ValueError, match="static"):
            TSweep.from_configs([base, other], data, nets, device="cpu")
    # seed, loss rate, burst length, rho, deadline seconds and
    # eligibility may vary
    TSweep.from_configs(
        [base, mk(seed=3, tra=TTRA(enabled=True, loss_rate=0.4),
                  netsim=TNetSim(channel="gilbert_elliott", burst_len=9.0,
                                 bw_rho=0.1, deadline_s=3.0),
                  selection="ratio", eligible_ratio=0.9)],
        data, nets, device="cpu")
    with pytest.raises(ValueError, match="networks"):
        TSweep.from_configs([base] * 3, data, [nets, nets], device="cpu")
    with pytest.raises(ValueError, match="datasets"):
        TSweep.from_configs([base] * 3, [data, data], nets, device="cpu")


def test_static_signature_and_key():
    """Scenario knobs and the round schedule leave the step's structure
    alone; the algorithm and the netsim models change it."""
    base = _grid(seeds=(0,), rates=(0.2,), bursts=(4.0,))[1][0]
    same = dataclasses.replace(
        base, seed=9, n_rounds=50, eval_every=7,
        tra=TTRA(enabled=True, loss_rate=0.4),
        netsim=TNetSim(channel="gilbert_elliott", burst_len=16.0,
                       deadline_s=2.0))
    assert _static_key(same) == _static_key(base)
    assert static_signature(same) != static_signature(base)   # schedule
    for other in (dataclasses.replace(base, algo="qfedavg"),
                  dataclasses.replace(base, netsim=TNetSim(bw_ar1=True))):
        assert _static_key(other) != _static_key(base)


def test_sweep_default_device_is_the_card(inputs, monkeypatch):
    cfgs = _grid(seeds=(0,), rates=(0.2,), bursts=(4.0,))[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSweep.from_configs(cfgs, inputs["tdata"], inputs["tnets"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_run_grid(cfgs, inputs["tdata"], inputs["tnets"])


def test_stage_scenarios_on_device_matches_reference(inputs):
    j = j_stage([inputs["jdata"], inputs["jhet"]])
    t = t_stage([inputs["tdata"], inputs["thet"]], "cpu")
    assert t.counts.shape == (2, N_CLIENTS) and t.n_clients == N_CLIENTS
    for name in ("train_x", "train_y", "counts"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert str(a.dtype) == f"torch.{b.dtype}"
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="client counts"):
        t_stage([inputs["tdata"],
                 t_generate(np.random.default_rng(2), n_clients=5)], "cpu")


def test_stage_network_scenarios_and_scenarios_match_reference(inputs):
    rng = np.random.default_rng(4)
    jn = [j_trace.sample_networks(rng, N_CLIENTS) for _ in range(3)]
    tn = [t_trace.ClientNetworks(n.upload_mbps, n.packet_loss) for n in jn]
    kw = dict(eligible_ratios=[1.0, 0.7, 0.5],
              thresholds_mbps=[2.0, 2.0, 8.0])
    sel = ["all", "ratio", "threshold"]
    np.testing.assert_array_equal(
        t_trace.stage_network_scenarios(tn, sel, **kw).numpy(),
        np.asarray(j_trace.stage_network_scenarios(jn, sel, **kw)))
    jcfgs, tcfgs = _grid(seeds=(0, 5), rates=(0.2,), bursts=(4.0,),
                         selection="ratio", eligible_ratio=0.7)
    for jc, tc in zip(jcfgs, tcfgs):
        a = j_scenario(jc, inputs["jdata"])
        b = t_scenario(tc, inputs["tdata"])
        np.testing.assert_array_equal(b.eligible, a.eligible)
        np.testing.assert_array_equal(b.sufficient, a.sufficient)
        np.testing.assert_array_equal(b.upload_mbps, a.upload_mbps)
        assert (b.seed, b.loss_rate) == (a.seed, a.loss_rate)
