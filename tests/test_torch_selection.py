"""The selection policy family (paper §5) against the JAX reference.

Both packages get the same numpy inputs made from a seed; server runs
start from the reference's weights (``convert.params_from_jax``).

Tolerances. The 0/1 scores (bandwidth_threshold, netsim_state), the
loss score and every traced row against its static one are bitwise;
where ``log1p`` enters (gradient_norm, staleness_aware,
reputation_aware, recovery_pressure) the port's float32 ``log1p`` is
within ``LOG1P_ULPS`` of XLA's (the logits one more). Cohorts are
bitwise. Server runs of 5 rounds: losses rtol 1e-5, params rtol 1e-4 /
atol 1e-5 (the engine tests' tolerances), the norm and loss memories
rtol 1e-5, the lateness and reputation memories bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.core import selection as j_sel
from repro.core.lossbudget import LossBudgetConfig as JBudget
from repro.core.mlp import mlp_init as j_mlp_init
from repro.core.server import FederatedServer as JServer
from repro.core.server import FLConfig as JConfig
from repro.core.server import run_grid as j_run_grid
from repro.core.sweep import SweepEngine as JSweep
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.netsim import NetSimConfig as JNetSim
from repro.netsim import delivery as j_dl
from repro.netsim import state as j_state
from repro.netsim.faults import DefenseConfig as JDefense
from repro.netsim.faults import FaultConfig as JFault
from repro.netsim.recovery import RecoveryConfig as JRecovery
from repro.network import trace as j_trace
from repro_torch import prng
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.core import engine as t_engine
from repro_torch.core import selection as t_sel
from repro_torch.core.lossbudget import LossBudgetConfig as TBudget
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.server import run_grid as t_run_grid
from repro_torch.core.sweep import SweepEngine as TSweep
from repro_torch.core.sweep import scenario_from_config
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.netsim import bandwidth as t_bw
from repro_torch.netsim import delivery as t_dl
from repro_torch.netsim import state as t_state
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.netsim.faults import DefenseConfig as TDefense
from repro_torch.netsim.faults import FaultConfig as TFault
from repro_torch.netsim.recovery import RecoveryConfig as TRecovery
from repro_torch.network import trace as t_trace
from repro_torch.network.packets import n_packets

N_CLIENTS = 20
ROUNDS = 5
# torch.log1p against XLA's log1p in float32: at most 2 ulps apart over
# 400,000 inputs from 1e-8 to 1e6 (torch's within 0.6 ulp of the exact
# value, XLA's within 2.5); the logits' scaling adds one rounding
LOG1P_ULPS = 2
# the deadline of the staleness cases, in seconds
DEADLINE_S = 0.1


@pytest.fixture(scope="module")
def small():
    """tests/test_torch_engine.py's setup: N = 20, ordered speeds."""
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    loss = np.full(N_CLIENTS, 0.05)
    return (j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5),
            j_trace.ClientNetworks(speeds, loss),
            t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5),
            t_trace.ClientNetworks(speeds, loss))


def _cfg(pkg, *, policy="uniform", traced=False, temperature=0.5,
         explore=0.0, algo="fedavg", loss_rate=0.2, netsim=None,
         faults=None, defense=None, recovery=None, lossbudget=None,
         **kw):
    """One configuration in either package (``pkg`` "j" or "t"): N = 20
    clients, C = 8, 4 local steps of 16, TRA with group_rate."""
    Cfg, Tra, Net, Flt, Dfn, Rec, Bud, Sel = (
        (JConfig, JTRA, JNetSim, JFault, JDefense, JRecovery, JBudget,
         j_sel.SelectionConfig) if pkg == "j" else
        (TConfig, TTRA, TNetSim, TFault, TDefense, TRecovery, TBudget,
         t_sel.SelectionConfig))
    return Cfg(algo=algo, n_rounds=ROUNDS, clients_per_round=8,
               local_steps=4, batch_size=16, eval_every=10 ** 6,
               lr=0.05 if algo == "scaffold" else 0.1,
               sel=Sel(policy=policy, traced=traced,
                       temperature=temperature, explore=explore),
               tra=Tra(enabled=True, loss_rate=loss_rate,
                       debias="group_rate"),
               netsim=Net(**(netsim or {})), faults=Flt(**(faults or {})),
               defense=Dfn(**(defense or {})),
               recovery=Rec(**(recovery or {})),
               lossbudget=Bud(**(lossbudget or {})), **kw)


def _vec(params, lead=()):
    return np.concatenate([np.asarray(params[k]).reshape(*lead, -1)
                           for k in sorted(params)], axis=-1)


# ---------------------------------------------------------------------------
# unit cases
# ---------------------------------------------------------------------------
def _score_inputs(seed, n=40):
    """Seeded score sources of every policy, as numpy arrays."""
    rng = np.random.default_rng(seed)
    logbw = rng.normal(1.0, 1.5, n).astype(np.float32)
    return dict(threshold_mbps=np.float32(2.0), logbw=logbw,
                gnorm_mem=rng.uniform(0, 3, n).astype(np.float32)
                * (rng.random(n) < 0.7),
                loss_mem=rng.uniform(0, 2, n).astype(np.float32),
                channel=(rng.random(n) < 0.4).astype(np.int32),
                stale_mem=np.where(rng.random(n) < 0.2, 1e6,
                                   rng.integers(0, 5, n)).astype(np.float32),
                rep_mem=(rng.integers(0, 80, n) / 36).astype(np.float32),
                bud_level=rng.integers(0, 3, n).astype(np.float32),
                bud_loss=rng.uniform(0, 0.5, n).astype(np.float32))


def _j(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _t(inputs):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


def _ulps(a, b):
    """Largest distance in float32 units in the last place."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if a.size else 0


EXACT = ("uniform", "bandwidth_threshold", "loss_aware", "netsim_state")


@pytest.mark.parametrize("policy", t_sel.POLICIES)
def test_policy_scores_match_reference(policy):
    """raw_policy_score, policy_logits and traced_policy_logits of every
    policy: the port's traced row is bitwise its static one; against
    the reference bitwise where the arithmetic is exact, within
    LOG1P_ULPS where log1p enters."""
    inputs = _score_inputs(5)
    # no client within float noise of the bandwidth cut
    assert np.abs(inputs["logbw"] - np.log(2.0)).min() > 1e-4
    knobs = dict(temperature=np.float32(0.7), explore=np.float32(0.2))
    j_raw = j_sel.raw_policy_score(policy, **_j(inputs))
    t_raw = t_sel.raw_policy_score(policy, **_t(inputs))
    j_lg = j_sel.policy_logits(policy, **_j(knobs), **_j(inputs))
    t_lg = t_sel.policy_logits(policy, **_t(knobs), **_t(inputs))
    onehot = t_sel.policy_onehot(policy)
    np.testing.assert_array_equal(onehot, j_sel.policy_onehot(policy))
    j_tr = j_sel.traced_policy_logits(jnp.asarray(onehot), **_j(knobs),
                                      **_j(inputs), n_clients=40)
    t_tr = t_sel.traced_policy_logits(torch.from_numpy(onehot),
                                      **_t(knobs), **_t(inputs),
                                      n_clients=40)
    if policy == "uniform":
        assert j_raw is None and t_raw is None and t_lg is None
        np.testing.assert_array_equal(t_tr.numpy(), 0.0)
        np.testing.assert_array_equal(np.asarray(j_tr), 0.0)
        return
    np.testing.assert_array_equal(t_tr.numpy(), t_lg.numpy())
    for t, j in ((t_raw, j_raw), (t_lg, j_lg), (t_tr, j_tr)):
        assert t.dtype == torch.float32 and t.shape == (40,)
        if policy in EXACT:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            bound = LOG1P_ULPS if t is t_raw else LOG1P_ULPS + 1
            assert _ulps(t.numpy(), np.asarray(j)) <= bound


def test_absent_score_sources_degrade_to_uniform():
    """A policy whose source is zero-size scores None (static) or zeros
    (traced), as the reference's."""
    empty = {k: torch.zeros((0,)) for k in
             ("logbw", "gnorm_mem", "loss_mem", "stale_mem", "rep_mem",
              "bud_level", "bud_loss")}
    empty["channel"] = torch.zeros((0,), dtype=torch.int32)
    for p in t_sel.POLICIES:
        assert t_sel.raw_policy_score(p, threshold_mbps=2.0,
                                      **empty) is None
        lg = t_sel.traced_policy_logits(
            torch.from_numpy(t_sel.policy_onehot(p)), temperature=0.5,
            explore=0.0, threshold_mbps=2.0, n_clients=7, **empty)
        np.testing.assert_array_equal(lg.numpy(), np.zeros(7, np.float32))
    with pytest.raises(ValueError):
        t_sel.SelectionConfig(policy="greedy")
    assert t_sel.SWEEP_VARYING_SEL_FIELDS == j_sel.SWEEP_VARYING_SEL_FIELDS
    assert t_sel.TEMP_EPS == j_sel.TEMP_EPS
    assert [f.name for f in dataclasses.fields(t_sel.SelectionConfig)] == \
        [f.name for f in dataclasses.fields(j_sel.SelectionConfig)]


def test_select_from_uniforms_with_logits_matches_reference():
    """Random eligibility and logits, k below, at and above the eligible
    count: cohorts bitwise."""
    rng = np.random.default_rng(11)
    for trial in range(12):
        n = int(rng.integers(4, 48))
        u = rng.uniform(1e-12, 1.0, n).astype(np.float32)
        lg = (rng.normal(0.0, 3.0, n)
              * (rng.random(n) < 0.8)).astype(np.float32)
        elig = rng.random(n) < 0.6
        elig[int(rng.integers(n))] = True
        m = int(elig.sum())
        for k in sorted({1, max(1, m - 1), m, min(n, m + 2), n}):
            j = np.asarray(j_sel.select_from_uniforms(
                jnp.asarray(u), jnp.asarray(lg), jnp.asarray(elig), k))
            t = t_sel.select_from_uniforms(torch.from_numpy(u),
                                           torch.from_numpy(lg),
                                           torch.from_numpy(elig), k)
            assert t.dtype == torch.int64 and t.shape == (k,)
            np.testing.assert_array_equal(t.numpy(), j)


def test_nan_scores_order_as_reference():
    """A NaN score (a failed client's norm, a diverged client's loss):
    the reference's arithmetic gives NaN keys whose sign bit is set, which
    ``top_k`` ranks below -inf, and the port ranks every NaN key there.
    The memories carry NaN as the reference's engine leaves them: the
    norm with its sign bit clear (log1p sets it), the loss with it set."""
    rng = np.random.default_rng(3)
    pos_nan = np.float32(np.nan)
    neg_nan = -np.abs(pos_nan)
    for trial in range(8):
        n = 24
        inputs = _score_inputs(40 + trial, n)
        hit = rng.random(n) < 0.3
        inputs["gnorm_mem"] = np.where(hit, pos_nan, inputs["gnorm_mem"])
        inputs["loss_mem"] = np.where(hit, neg_nan, inputs["loss_mem"])
        u = rng.uniform(1e-12, 1.0, n).astype(np.float32)
        elig = rng.random(n) < 0.8
        for policy in ("gradient_norm", "loss_aware"):
            for traced in (False, True):
                kw = dict(temperature=np.float32(0.5),
                          explore=np.float32(0.0))
                if traced:
                    oh = t_sel.policy_onehot(policy)
                    jl = j_sel.traced_policy_logits(
                        jnp.asarray(oh), **_j(kw), **_j(inputs),
                        n_clients=n)
                    tl = t_sel.traced_policy_logits(
                        torch.from_numpy(oh), **_t(kw), **_t(inputs),
                        n_clients=n)
                else:
                    jl = j_sel.policy_logits(policy, **_j(kw), **_j(inputs))
                    tl = t_sel.policy_logits(policy, **_t(kw), **_t(inputs))
                assert np.isnan(tl.numpy()).sum() == hit.sum()
                for k in (3, int(elig.sum()), n):
                    j = np.asarray(j_sel.select_from_uniforms(
                        jnp.asarray(u), jl, jnp.asarray(elig), k))
                    t = t_sel.select_from_uniforms(
                        torch.from_numpy(u), tl, torch.from_numpy(elig), k)
                    np.testing.assert_array_equal(t.numpy(), j)


def test_select_clients_matches_reference():
    rng = np.random.default_rng(2)
    for seed in range(6):
        n = 30
        scores = rng.normal(0.0, 1.0, n).astype(np.float32)
        elig = rng.random(n) < 0.7
        for s in (None, scores):
            j = np.asarray(j_sel.select_clients(
                jax.random.PRNGKey(seed),
                None if s is None else jnp.asarray(s), jnp.asarray(elig), 8))
            t = t_sel.select_clients(
                prng.PRNGKey(seed), None if s is None else torch.from_numpy(s),
                torch.from_numpy(elig), 8)
            np.testing.assert_array_equal(t.numpy(), j)
        t = t_engine.gumbel_topk_select(prng.PRNGKey(seed),
                                        torch.from_numpy(elig), 8)
        j = np.asarray(j_sel.select_clients(jax.random.PRNGKey(seed), None,
                                            jnp.asarray(elig), 8))
        np.testing.assert_array_equal(t.numpy(), j)


def test_good_state_scores_match_reference():
    ch = np.random.default_rng(4).integers(0, 2, 50).astype(np.int32)
    j = j_state.good_state_scores(j_state.NetSimState(
        jnp.asarray(ch), jnp.zeros((0,), jnp.float32)))
    t = t_state.good_state_scores(t_state.NetSimState(
        torch.from_numpy(ch), torch.zeros((0,)),
        torch.zeros((0,), dtype=torch.int32)))
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_arrival_lateness_matches_reference():
    """Seconds at, one ulp around and far from whole multiples of the
    deadline, infeasible uploads, and degenerate deadlines: bitwise."""
    dl = np.float32(DEADLINE_S)
    mult = np.array([0.5, 1.0, 2.0, 3.0, 7.0], np.float32) * dl
    secs = np.concatenate([
        mult, np.nextafter(mult, np.float32(np.inf)),
        np.nextafter(mult, np.float32(0.0)),
        np.random.default_rng(6).uniform(0, 2, 20).astype(np.float32),
        np.float32([t_dl.INFEASIBLE_SECS, 0.0, np.inf, np.nan])])
    assert t_dl.MAX_LATENESS == j_dl.MAX_LATENESS
    for d in (dl, np.float32(0.0), np.float32(-1.0), np.float32(np.nan),
              np.float32(np.inf), np.float32(1e-30)):
        j = np.asarray(j_dl.arrival_lateness(jnp.asarray(secs),
                                             jnp.asarray(d)))
        t = t_dl.arrival_lateness(torch.from_numpy(secs),
                                  torch.tensor(d)).numpy()
        np.testing.assert_array_equal(t, j)
        assert np.isfinite(t).all()
    t = t_dl.arrival_lateness(torch.from_numpy(secs), float(dl)).numpy()
    np.testing.assert_array_equal(
        t, np.asarray(j_dl.arrival_lateness(jnp.asarray(secs), dl)))


@pytest.mark.parametrize("retransmit", [False, True])
def test_upload_seconds_matches_reference(retransmit):
    for n_bytes, mbps, loss in ((36864.0, 2.0, 0.1), (1e6, 0.5, 0.0),
                                (4096.0, 20.0, 0.99), (4096.0, 8.0, 1.0)):
        assert t_trace.upload_seconds(n_bytes, mbps, loss, retransmit) == \
            j_trace.upload_seconds(n_bytes, mbps, loss, retransmit)


@pytest.mark.parametrize("selection", ["all", "ratio", "threshold"])
def test_host_select_matches_reference(small, selection):
    """``FederatedServer.select``: the server's numpy generator draws the
    reference's cohorts, bit for bit."""
    jdata, jnets, tdata, tnets = small
    kw = dict(selection=selection, eligible_ratio=0.7)
    js = JServer(_cfg("j", **kw), jdata, jnets)
    ts = TServer(_cfg("t", **kw), tdata, tnets, device="cpu")
    np.testing.assert_array_equal(ts.eligible_mask(), js.eligible_mask())
    for _ in range(4):
        np.testing.assert_array_equal(ts.select(), js.select())


# ---------------------------------------------------------------------------
# server rounds
# ---------------------------------------------------------------------------
GE = dict(channel="gilbert_elliott", burst_len=4.0)
DEADLINE = dict(bw_ar1=True, bw_rho=0.8, deadline=True,
                deadline_s=DEADLINE_S)
SERVER_CASES = {
    "bandwidth_threshold": dict(policy="bandwidth_threshold",
                                temperature=0.05),
    "gradient_norm": dict(policy="gradient_norm", error_feedback=True),
    "gradient_norm_scaffold": dict(policy="gradient_norm", algo="scaffold"),
    "loss_aware": dict(policy="loss_aware"),
    "netsim_state": dict(policy="netsim_state", temperature=0.05,
                         netsim=GE),
    "staleness_aware": dict(policy="staleness_aware", netsim=DEADLINE),
    # bit flips quarantine only once a flipped exponent overflows the
    # next round, which takes every upload and zeroes the model (a ReLU
    # kink where trajectories part); with the clip they stay finite, and
    # the NaN failures are what the screen quarantines
    "reputation_aware": dict(policy="reputation_aware",
                             faults=dict(enabled=True, bitflip_rate=0.5,
                                         fail_rate=0.2),
                             defense=dict(screen=True, clip=True)),
    "recovery_pressure": dict(policy="recovery_pressure", netsim=GE,
                              recovery=dict(traced=True),
                              lossbudget=dict(enabled=True, budget=0.05,
                                              ema=0.3)),
    "traced": dict(policy="gradient_norm", traced=True,
                   netsim={**GE, **DEADLINE}),
}
MEMS = ("gnorm_mem", "loss_mem", "stale_mem", "rep_mem", "bud_level")


def _run_pair(small, case, rounds=ROUNDS):
    """Both servers from the reference's weights, ``rounds`` rounds in one
    block: cohorts bitwise, losses and params at the engine tolerances."""
    jdata, jnets, tdata, tnets = small
    jc, tc = _cfg("j", **case), _cfg("t", **case)
    js = JServer(jc, jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    jst, jlogs = js.engine.run_block(js.engine.init_state(js.params), 0,
                                     rounds)
    ts = TServer(tc, tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    t0 = ts.engine.init_state(ts.params)
    tst, tlogs = ts.engine.run_block(t0, 0, rounds)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    np.testing.assert_allclose(_vec(tst.params), _vec(jst.params),
                               rtol=1e-4, atol=1e-5)
    for name in ("quarantine", "arrival"):
        if name in jlogs:
            np.testing.assert_array_equal(tlogs[name], jlogs[name])
    return jst, jlogs, tst, tlogs, t0, ts


def _check_memories(tst, jst):
    for name in MEMS:
        t, j = getattr(tst, name).numpy(), np.asarray(getattr(jst, name))
        assert t.shape == j.shape, name
        if name in ("gnorm_mem", "loss_mem"):
            np.testing.assert_allclose(t, j, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)


def _lateness_margin(cfg, t0, ts, ids):
    """Each round's upload seconds of its cohort over the deadline,
    replayed from the port's initial levels: no cohort client may lie
    within the AR(1) normals' ulps of a whole number of deadlines."""
    D = sum(v.numel() for v in t0.params.values())
    P = n_packets(D, cfg.tra.packet_floats)
    ctx = ts.engine.ctx
    logbw = t0.net.logbw
    ratios = []
    for t in range(len(ids)):
        logbw = t_bw.logbw_round_step(prng.fold_in(ctx.base_key, t), logbw,
                                      ctx.bw_rho)
        cid = torch.tensor(ids[t])
        ratios.append(t_dl.round_upload_seconds(
            P, cfg.tra.packet_floats, torch.exp(logbw[cid]),
            ctx.loss_rate, ctx.sufficient[cid].bool()).numpy()
            / cfg.netsim.deadline_s)
    r = np.concatenate(ratios)
    r = r[r > 0.5]
    return float(np.abs(r - np.round(r)).min())


@pytest.mark.parametrize("label", list(SERVER_CASES))
def test_server_rounds_match_reference(small, label):
    """5 rounds of each policy with the model its score needs."""
    case = SERVER_CASES[label]
    jst, jlogs, tst, tlogs, t0, ts = _run_pair(small, case)
    _check_memories(tst, jst)
    cfg = ts.cfg
    if cfg.netsim.deadline:
        assert _lateness_margin(cfg, t0, ts, tlogs["ids"]) > 1e-4
        assert (tst.stale_mem.numpy() > 0).any()      # some were late
    if label == "reputation_aware":
        assert (tst.rep_mem.numpy() > 0).any()        # quarantines
    if label == "bandwidth_threshold":
        # the hard threshold never picks the two clients under 2 Mbps
        below = np.flatnonzero(small[3].upload_mbps < 2.0)
        assert below.size and not np.isin(tlogs["ids"], below).any()
    if label == "gradient_norm_scaffold":
        np.testing.assert_allclose(tst.c_i.numpy(), np.asarray(jst.c_i),
                                   rtol=1e-4, atol=1e-5)
    # the score memories ride across a convert of the reference's state
    conv = engine_state_from_jax(jst, "cpu")
    for name in MEMS:
        np.testing.assert_array_equal(getattr(conv, name).numpy(),
                                      np.asarray(getattr(jst, name)))


def test_gradient_norm_nan_uploads_match_reference(small):
    """Failed clients upload NaN with the screen off: their norms (and
    then every model) turn NaN, and the cohorts still follow the
    reference's order of NaN keys."""
    case = dict(policy="gradient_norm",
                faults=dict(enabled=True, fail_rate=0.3))
    jst, _, tst, _, _, _ = _run_pair(small, case, rounds=4)
    assert np.isnan(tst.gnorm_mem.numpy()).any()
    np.testing.assert_array_equal(np.isnan(tst.gnorm_mem.numpy()),
                                  np.isnan(np.asarray(jst.gnorm_mem)))


# ---------------------------------------------------------------------------
# the traced grid
# ---------------------------------------------------------------------------
GRID_RATES = (0.1, 0.3)


def _grid(pkg, rounds=ROUNDS):
    """Every policy x loss {0.1, 0.3}, traced, on the GE channel, with the
    example's temperatures."""
    temps = {"bandwidth_threshold": 0.05, "netsim_state": 0.05,
             "uniform": 1.0}
    return [dataclasses.replace(
        _cfg(pkg, policy=p, traced=True, temperature=temps.get(p, 0.5),
             loss_rate=r, netsim=GE), n_rounds=rounds)
        for p in t_sel.POLICIES for r in GRID_RATES]


def test_traced_grid_matches_reference(small):
    """16 cells as one batched step a round, against the reference's
    SweepEngine and run_grid: cohorts and channel states bitwise,
    params, memories, losses and final reports at the tolerances."""
    jdata, jnets, tdata, tnets = small
    jcfgs, tcfgs = _grid("j"), _grid("t")
    S = len(tcfgs)
    jeng = JSweep.from_configs(jcfgs, jdata, jnets)
    teng = TSweep.from_configs(tcfgs, tdata, tnets, device="cpu")
    init = [{k: np.asarray(v) for k, v in
             j_mlp_init(jax.random.PRNGKey(c.seed)).items()} for c in jcfgs]
    tinit = [params_from_jax(p, "cpu") for p in init]
    jst, jlogs = jeng.run_block(jeng.init_states(), 0, ROUNDS)
    tst, tlogs = teng.run_block(teng.init_states(tinit), 0, ROUNDS)
    assert tlogs["ids"].shape == (S, ROUNDS, 8)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_array_equal(tst.net.channel.numpy(),
                                  np.asarray(jst.net.channel))
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    np.testing.assert_allclose(_vec(tst.params, (S,)),
                               _vec(jst.params, (S,)), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tst.gnorm_mem.numpy(),
                               np.asarray(jst.gnorm_mem), rtol=1e-5)
    np.testing.assert_allclose(tst.loss_mem.numpy(),
                               np.asarray(jst.loss_mem), rtol=1e-5)
    assert tst.stale_mem.shape == (S, N_CLIENTS)
    # the score policies part from uniform's cohorts; the policies whose
    # source this grid lacks (no deadline, faults or controller) score
    # zeros and draw uniform's
    ids = {(c.sel.policy, c.tra.loss_rate): tlogs["ids"][i]
           for i, c in enumerate(tcfgs)}
    for r in GRID_RATES:
        for p in ("bandwidth_threshold", "gradient_norm", "loss_aware"):
            assert not np.array_equal(ids[p, r], ids["uniform", r]), p
        for p in ("staleness_aware", "reputation_aware",
                  "recovery_pressure"):
            np.testing.assert_array_equal(ids[p, r], ids["uniform", r])
    jh = j_run_grid(jcfgs, jdata, jnets)
    th = t_run_grid(tcfgs, tdata, tnets, device="cpu", init_params=tinit)
    for a, b in zip(th, jh):
        np.testing.assert_allclose([h.train_loss for h in a],
                                   [h.train_loss for h in b], rtol=1e-5)
        ja, ta = b[-1].report.as_dict(), a[-1].report.as_dict()
        for k in ja:
            assert abs(ta[k] - ja[k]) <= 1e-6 * max(1.0, abs(ja[k])), k


def test_traced_cells_equal_static_runs(small):
    """A traced grid cell is its static policy's run, bit for bit: the
    one-hot contraction gives the static logits' bits."""
    _, _, tdata, tnets = small
    cfgs = _grid("t")
    eng = TSweep.from_configs(cfgs, tdata, tnets, device="cpu")
    st, logs = eng.run_block(eng.init_states(), 0, ROUNDS)
    for p in ("uniform", "bandwidth_threshold", "gradient_norm",
              "loss_aware", "netsim_state"):
        i = 2 * t_sel.POLICIES.index(p) + 1          # loss 0.3
        c = cfgs[i]
        srv = TServer(dataclasses.replace(
            c, sel=dataclasses.replace(c.sel, traced=False)), tdata, tnets,
            device="cpu")
        s1, l1 = srv.engine.run_block(srv.engine.init_state(srv.params), 0,
                                      ROUNDS)
        np.testing.assert_array_equal(logs["ids"][i], l1["ids"])
        np.testing.assert_array_equal(_vec(st.params, (len(cfgs),))[i],
                                      _vec(s1.params))
        if p == "gradient_norm":
            np.testing.assert_array_equal(st.gnorm_mem[i].numpy(),
                                          s1.gnorm_mem.numpy())


@pytest.mark.parametrize("a,b", [
    (dict(policy="gradient_norm", traced=True), dict(policy="gradient_norm")),
    (dict(policy="gradient_norm"), dict(policy="loss_aware"))])
def test_grid_refuses_mixed_static_selection(small, a, b):
    """Static policies and the traced flag must agree across a sweep,
    in the configs and in each Scenario's own ``sel``; only traced
    configs vary the policy. Without speeds the traced family has no
    bandwidth score."""
    _, _, tdata, tnets = small
    ca, cb = _cfg("t", **a), _cfg("t", **b)
    with pytest.raises(ValueError, match="static"):
        TSweep.from_configs([ca, cb], tdata, tnets, device="cpu")
    with pytest.raises(ValueError, match="static selection"):
        TSweep(ca, [scenario_from_config(cb, tdata, tnets)], device="cpu")
    sc = dataclasses.replace(scenario_from_config(ca, tdata, tnets),
                             upload_mbps=None)
    if ca.sel.traced:
        with pytest.raises(ValueError, match="upload_mbps"):
            TSweep(ca, [sc], device="cpu")
    else:
        TSweep(ca, [sc], device="cpu")


def test_bias_headline_cohorts_match_reference():
    """The paper's bias result at tests/test_selection_bias.py's setup
    (N = 40, C = 8, TRA 10%, FCC draw 2026), cut from 40 rounds to 20:
    uniform, the hard threshold and the threshold with explore=1 draw
    the reference's cohorts bit for bit, so their bottom-quartile shares
    are the reference's. The reference's own 0.10 margin is not held: it
    fails on this tree."""
    n, rounds = 40, 20
    speeds = j_trace.sample_networks(np.random.default_rng(2026), n)
    jnets = j_trace.ClientNetworks(speeds.upload_mbps, speeds.packet_loss)
    tnets = t_trace.ClientNetworks(speeds.upload_mbps, speeds.packet_loss)
    # no client within float noise of the 2 Mbps cut
    logbw = np.log(speeds.upload_mbps.astype(np.float32))
    assert np.abs(logbw - np.log(np.float32(2.0))).min() > 1e-4
    jdata = j_generate(np.random.default_rng(0), n_clients=n, alpha=0.5,
                       beta=0.5)
    tdata = t_generate(np.random.default_rng(0), n_clients=n, alpha=0.5,
                       beta=0.5)
    bottom = np.argsort(speeds.upload_mbps)[:n // 4]
    shares = {}
    for label, sel in (("uniform", dict(policy="uniform")),
                       ("threshold", dict(policy="bandwidth_threshold",
                                          temperature=0.05)),
                       ("explore", dict(policy="bandwidth_threshold",
                                        temperature=0.05, explore=1.0))):
        ids = []
        for pkg, Srv, data, nets in (("j", JServer, jdata, jnets),
                                     ("t", TServer, tdata, tnets)):
            cfg = dataclasses.replace(
                _cfg(pkg, **sel, loss_rate=0.1), n_rounds=rounds,
                local_steps=1, batch_size=8, seed=0,
                tra=(JTRA if pkg == "j" else TTRA)(enabled=True,
                                                   loss_rate=0.1))
            srv = Srv(cfg, data, nets) if pkg == "j" \
                else Srv(cfg, data, nets, device="cpu")
            _, logs = srv.engine.run_block(srv.engine.init_state(srv.params),
                                           0, rounds)
            ids.append(np.asarray(logs["ids"]))
        np.testing.assert_array_equal(ids[1], ids[0])
        shares[label] = np.isin(ids[1], bottom).mean()
    # the threshold starves the bottom quartile; explore=1 restores it
    assert shares["threshold"] < shares["uniform"] - 0.1
    assert shares["explore"] == shares["uniform"]
