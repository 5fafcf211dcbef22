"""The async server (sync / semi_sync / async) against the JAX reference.

Both packages get the same numpy inputs made from a seed; engine runs
start from the reference's weights, or from its state converted with
``convert.engine_state_from_jax``.

Tolerances:
  * bitwise: cohorts, the channel states, the buffer's due rounds and
    staleness, the sync arrival bits and the quarantine counts; the
    buffer functions on fixed cases (a stable sort, gathers and 0/1
    gates are exact); ``grace_staleness`` and ``mode_onehot``; and
    ``buffer_pop_ready`` and the recombination against the reference's
    jitted expressions: XLA fuses their multiply-adds (each step of the
    pop's sums, and agg * den + num), which the port computes in float64
    and rounds once;
  * ``staleness_weight``: exactly 1.0 at tau = 0 and at alpha = 0 on both
    sides, elsewhere within POW_ULPS of XLA's ``pow``; where XLA's result
    falls below the smallest normal float it flushes it to 0, and the
    port's is that subnormal;
  * engine rounds against the reference, 4 rounds from its weights (the
    engine tests' tolerances, tests/test_torch_engine.py says why runs
    stay short): losses rtol 1e-5, params and the buffer's vectors rtol
    1e-4 / atol 1e-5, the arrival weights rtol 1e-6;
  * the port against itself: a traced grid cell against its static run
    with cohorts, due and tau bitwise, losses and params rtol 1e-6 /
    atol 1e-7 (under vmap the cohort's SGD is one batched GEMM); async
    and semi_sync under a loose deadline bitwise its sync.

The headline is the reference's (tests/test_async.py): 30% bursty loss
and a 0.1 s deadline the slow quartile can never meet, 30 rounds; the
reference runs beside the port as the yardstick.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.core import async_agg as j_async
from repro.core.async_agg import AsyncConfig as JAsync
from repro.core.mlp import mlp_init as j_mlp_init
from repro.core.selection import SelectionConfig as JSel
from repro.core.server import FederatedServer as JServer
from repro.core.server import FLConfig as JConfig
from repro.core.sweep import SweepEngine as JSweep
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.netsim import NetSimConfig as JNetSim
from repro.netsim import delivery as j_dl
from repro.netsim.faults import DefenseConfig as JDefense
from repro.netsim.faults import FaultConfig as JFault
from repro.netsim.recovery import RecoveryConfig as JRecovery
from repro.network.trace import ClientNetworks as JNets
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.core import async_agg as t_async
from repro_torch.core.async_agg import AsyncConfig as TAsync
from repro_torch.core.mlp import mlp_weighted_loss
from repro_torch.core.selection import SelectionConfig as TSel
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.server import run_grid as t_run_grid
from repro_torch.core.sweep import SweepEngine as TSweep
from repro_torch.core.sweep import scenario_from_config
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.data.synthetic import stage_on_device
from repro_torch.kernels.common import DENOM_EPS
from repro_torch.netsim import delivery as t_dl
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.netsim.faults import DefenseConfig as TDefense
from repro_torch.netsim.faults import FaultConfig as TFault
from repro_torch.netsim.recovery import RecoveryConfig as TRecovery
from repro_torch.network.trace import ClientNetworks as TNets

N_CLIENTS = 20
ROUNDS = 4
# torch.pow against XLA's pow in float32 (1 + tau)^(-alpha): at most one
# ulp apart over 100,000 staleness values for alpha from 0.1 to 2.5
POW_ULPS = 1
EMPTY = np.float32(t_async.EMPTY_DUE)


@pytest.fixture(scope="module")
def small():
    """tests/test_async.py's setup: N = 20, speeds 0.5 to 20 Mbps."""
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    loss = np.full(N_CLIENTS, 0.05)
    return (j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), JNets(speeds, loss),
            t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), TNets(speeds, loss))


def _cfg(pkg, mode="sync", *, algo="fedavg", ef=True, traced=False,
         loss_rate=0.3, deadline_s=0.1, rounds=ROUNDS, cpr=8, buffer_k=6,
         alpha=0.5, grace_s=0.2, seed=3, debias="group_rate", faults=None,
         defense=None, deadline=True, bw_ar1=False, policy="uniform",
         recovery=None):
    """tests/test_async.py's configuration in either package (``pkg`` "j"
    or "t"): 2 local steps of 8, TRA on the Gilbert-Elliott channel
    (burst 8) under a deadline."""
    Cfg, Tra, Net, Srv, Flt, Dfn, Sel, Rec = (
        (JConfig, JTRA, JNetSim, JAsync, JFault, JDefense, JSel, JRecovery)
        if pkg == "j" else
        (TConfig, TTRA, TNetSim, TAsync, TFault, TDefense, TSel, TRecovery))
    return Cfg(
        algo=algo, n_rounds=rounds, clients_per_round=cpr, local_steps=2,
        batch_size=8, eval_every=10 ** 6, seed=seed, error_feedback=ef,
        lr=0.05 if algo == "scaffold" else 0.1,
        tra=Tra(enabled=True, loss_rate=loss_rate, debias=debias),
        netsim=Net(channel="gilbert_elliott", burst_len=8.0,
                   deadline=deadline, deadline_s=deadline_s, bw_ar1=bw_ar1),
        srv=Srv(mode=mode, traced=traced, buffer_k=buffer_k,
                staleness_alpha=alpha, grace_s=grace_s),
        faults=Flt(**(faults or {})), defense=Dfn(**(defense or {})),
        sel=Sel(policy=policy), recovery=Rec(**(recovery or {})))


def _vec(params, lead=()):
    return np.concatenate([np.asarray(params[k]).reshape(*lead, -1)
                           for k in sorted(params)], axis=-1)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    return int(np.abs(ia - ib).max()) if a.size else 0


def _jbuf(dues, k=6, d=4, taus=None, ws=None):
    """A buffer of ``k`` slots holding ``len(dues)`` live entries whose
    vectors are marked 1, 2, ...: (reference buffer, port buffer)."""
    n = len(dues)
    vec = np.zeros((k, d), np.float32)
    vec[:n] = np.arange(1, n + 1, dtype=np.float32)[:, None]
    due = np.full(k, EMPTY, np.float32)
    due[:n] = dues
    w = np.zeros(k, np.float32)
    w[:n] = 1.0 if ws is None else ws
    tau = np.zeros(k, np.float32)
    tau[:n] = 0.0 if taus is None else taus
    arrs = (vec, due, w, tau)
    return (j_async.ArrivalBuffer(*(jnp.asarray(a) for a in arrs)),
            t_async.ArrivalBuffer(*(torch.from_numpy(a) for a in arrs)))


def _same_buf(tb, jb):
    for name in t_async.ArrivalBuffer._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# unit cases
# ---------------------------------------------------------------------------
def test_constants_and_config_match_reference():
    assert t_async.MODES == j_async.MODES
    assert np.float32(t_async.EMPTY_DUE) == np.float32(j_async.EMPTY_DUE)
    assert t_async.SWEEP_VARYING_SRV_FIELDS == \
        j_async.SWEEP_VARYING_SRV_FIELDS
    assert [f.name for f in dataclasses.fields(TAsync)] == \
        [f.name for f in dataclasses.fields(JAsync)]
    assert TAsync() == TAsync(**dataclasses.asdict(JAsync()))
    for m in t_async.MODES:
        np.testing.assert_array_equal(t_async.mode_onehot(m),
                                      j_async.mode_onehot(m))
        assert t_async.mode_onehot(m).dtype == np.float32
    with pytest.raises(ValueError, match="mode"):
        TAsync(mode="buffered")
    with pytest.raises(ValueError, match="buffer_k"):
        TAsync(buffer_k=0)


def test_staleness_weight_matches_reference():
    rng = np.random.default_rng(0)
    tau = np.concatenate([rng.uniform(0, 50, 20000),
                          rng.integers(0, 100, 500),
                          [0.0, 1.0, 3.0, 1e6, -3.0, -0.0]]).astype(np.float32)
    for alpha in (0.0, 0.1, 0.5, 0.7, 1.0, 2.5, 100.0):
        j = np.asarray(jax.jit(j_async.staleness_weight)(
            jnp.asarray(tau), jnp.float32(alpha)))
        t = t_async.staleness_weight(torch.from_numpy(tau),
                                     torch.tensor(alpha)).numpy()
        assert t.dtype == np.float32 and np.isfinite(t).all()
        zero = tau <= 0
        np.testing.assert_array_equal(t[zero], 1.0)
        np.testing.assert_array_equal(j[zero], 1.0)
        if alpha == 0.0:
            np.testing.assert_array_equal(t, 1.0)
        normal = j >= np.finfo(np.float32).tiny
        assert _ulps(t[normal], j[normal]) <= POW_ULPS, alpha
        # XLA flushes what falls below the smallest normal to 0
        assert (t[~normal] < np.finfo(np.float32).tiny).all()
    # a Python float tau and alpha, as the unit cases of the reference
    assert float(t_async.staleness_weight(3.0, 0.5)) == pytest.approx(0.5)


def test_grace_staleness_matches_reference():
    """Seconds before, at, one ulp around and far past the deadline,
    infeasible uploads, and degenerate deadlines: bitwise."""
    dl = np.float32(0.1)
    mult = np.array([0.5, 1.0, 1.5, 2.0, 7.0], np.float32) * dl
    secs = np.concatenate([
        mult, np.nextafter(mult, np.float32(np.inf)),
        np.nextafter(mult, np.float32(0.0)),
        np.random.default_rng(6).uniform(0, 2, 20).astype(np.float32),
        np.float32([t_dl.INFEASIBLE_SECS, 0.0, np.inf, np.nan])])
    for d in (dl, np.float32(0.0), np.float32(-1.0), np.float32(np.nan),
              np.float32(np.inf), np.float32(1e-30)):
        j = np.asarray(j_dl.grace_staleness(jnp.asarray(secs),
                                            jnp.asarray(d)))
        t = t_dl.grace_staleness(torch.from_numpy(secs),
                                 torch.tensor(d)).numpy()
        np.testing.assert_array_equal(t, j)
        assert np.isfinite(t).all() and (t >= 0).all()
    t = t_dl.grace_staleness(torch.from_numpy(secs), float(dl)).numpy()
    np.testing.assert_array_equal(
        t, np.asarray(j_dl.grace_staleness(jnp.asarray(secs), dl)))


POP_CASES = {
    "mixed": ([2.0, 9.0, 1.0, 2.0], [1.0, 3.0, 0.0, 2.0], [2.0, 5.0, 1.5,
                                                           0.25]),
    "all_ready": ([0.0, 1.0, 2.0], [1.0, 1.0, 4.0], [1.0, 1.0, 1.0]),
    "none_ready": ([3.0, 4.0], [1.0, 2.0], [1.0, 1.0]),
    "empty": ([], [], []),
}


@pytest.mark.parametrize("case", list(POP_CASES))
def test_buffer_pop_ready_matches_reference(case):
    """Ready entries at t = 2 fold into (num, den) bitwise the reference's
    jitted pop (its fused multiply-adds included), and the cleared buffer
    bitwise; an empty or not-yet-due buffer pops exact zeros."""
    dues, taus, ws = POP_CASES[case]
    rng = np.random.default_rng(len(dues))
    for alpha in (0.5, 1.0):
        jb, tb = _jbuf(dues, k=6, d=300, taus=taus, ws=ws)
        vec = rng.normal(size=(6, 300)).astype(np.float32)
        jb = jb._replace(vec=jnp.asarray(vec))
        tb = tb._replace(vec=torch.from_numpy(vec))
        jn, jd, jc = jax.jit(j_async.buffer_pop_ready)(
            jb, jnp.float32(2.0), jnp.float32(alpha))
        tn, td, tc = t_async.buffer_pop_ready(tb, torch.tensor(2.0),
                                              torch.tensor(alpha))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert td.item() == float(jd)
        _same_buf(tc, jc)
        if case in ("empty", "none_ready"):
            np.testing.assert_array_equal(tn.numpy(), 0.0)
            assert td.item() == 0.0
    if case == "mixed":
        # alpha 1: the tau = 1 entry counts half, the tau = 2 one a third
        ready = np.array([1, 0, 1, 1, 0, 0], np.float32)
        w = np.float32(1.0) / (1 + tb.tau.numpy()) * ready
        np.testing.assert_allclose(td.item(), (w * tb.w.numpy()).sum(),
                                   rtol=1e-6)
        assert (tc.due.numpy()[[0, 2, 3]] == EMPTY).all()


def test_recombination_matches_reference_fused():
    """The engine's recombination (agg * max(den_on, eps) + num) / max(den,
    eps): XLA fuses the multiply-add in the reference's jitted step, and
    the port's ``fma`` gives its bits."""
    rng = np.random.default_rng(4)

    @jax.jit
    def j_recombine(agg, den_on, num, den):
        return (agg * jnp.maximum(den_on, DENOM_EPS) + num) \
            / jnp.maximum(den_on + den, DENOM_EPS)

    for trial in range(20):
        agg = rng.normal(size=2000).astype(np.float32)
        num = rng.normal(size=2000).astype(np.float32)
        den_on, den = rng.uniform(0, 2, 2).astype(np.float32)
        if trial == 0:
            den_on = np.float32(0.0)
        j = np.asarray(j_recombine(agg, den_on, num, den))
        t = (t_async.fma(torch.from_numpy(agg),
                         torch.clamp(torch.tensor(den_on), min=DENOM_EPS),
                         torch.from_numpy(num))
             / torch.clamp(torch.tensor(den_on) + torch.tensor(den),
                           min=DENOM_EPS)).numpy()
        np.testing.assert_array_equal(t, j)


INSERT_CASES = {
    # existing dues, candidate dues, live bits, K
    "ties": ([2.0], [2.0, 2.0], [True, True], 3),
    "overflow": ([5.0, 7.0], [1.0, 6.0, 3.0], [True, False, True], 2),
    "overflow_ties": ([4.0, 4.0], [4.0, 1.0, 4.0, 2.0],
                      [True, True, True, True], 3),
    "all_gated": ([3.0], [1.0, 2.0], [False, False], 4),
    "k1": ([3.0], [5.0, 3.0, 1.0], [True, True, False], 1),
    "into_empty": ([], [7.0, 2.0, 2.0, 9.0], [True, True, True, True], 6),
}


@pytest.mark.parametrize("case", list(INSERT_CASES))
def test_buffer_insert_matches_reference(case):
    """Ties (existing slots first, then cohort order), overflow (the K
    earliest kept), gated-off candidates, K = 1: bitwise the reference's
    buffer, slot by slot."""
    exist, cand, live, k = INSERT_CASES[case]
    jb, tb = _jbuf(exist, k=k, d=4, taus=[1.0] * len(exist))
    n = len(cand)
    cvec = (100.0 + np.arange(n, dtype=np.float32))[:, None] \
        * np.ones((1, 4), np.float32)
    args = (cvec, np.asarray(cand, np.float32),
            np.linspace(0.5, 1.0, n).astype(np.float32),
            np.arange(1, n + 1, dtype=np.float32), np.asarray(live))
    j = jax.jit(j_async.buffer_insert)(jb, *(jnp.asarray(a) for a in args))
    t = t_async.buffer_insert(tb, *(torch.from_numpy(a) for a in args))
    _same_buf(t, j)
    assert (np.diff(t.due.numpy()) >= 0).all()
    if case == "ties":
        np.testing.assert_array_equal(t.vec.numpy()[:, 0], [1, 100, 101])
    if case == "all_gated":
        np.testing.assert_array_equal(t.due.numpy()[1:], EMPTY)
        np.testing.assert_array_equal(t.vec.numpy()[1:], 0.0)


def test_buffer_insert_denormal_due_matches_oracle():
    """The reference's denormal cases (ROADMAP Queue 3: XLA's CPU sort
    compares a denormal due time as 0, the numpy oracle does not): the
    port's stable sort orders a due of 1.4e-45 after 0.0, as the numpy
    oracle does, so it matches the oracle there. The engine never meets
    it: its due times are whole rounds or EMPTY_DUE."""
    tiny = np.float32(1.4e-45)
    for exist, cand, k in (([tiny], [0.0], 1), ([], [tiny, 0.0], 2),
                           ([tiny], [0.0, tiny], 3)):
        _, tb = _jbuf(exist, k=k, d=2)
        n = len(cand)
        cvec = (100.0 + np.arange(n, dtype=np.float32))[:, None] \
            * np.ones((1, 2), np.float32)
        out = t_async.buffer_insert(
            tb, torch.from_numpy(cvec), torch.tensor(cand, dtype=torch.float32),
            torch.ones(n), torch.zeros(n), torch.ones(n, dtype=torch.bool))
        dues = np.concatenate([tb.due.numpy(), np.float32(cand)])
        order = np.argsort(dues, kind="stable")[:k]
        np.testing.assert_array_equal(out.due.numpy(), dues[order])
        markers = np.concatenate([tb.vec.numpy()[:, 0], cvec[:, 0]])
        np.testing.assert_array_equal(out.vec.numpy()[:, 0], markers[order])
        assert out.due.numpy()[0] == 0.0


# ---------------------------------------------------------------------------
# engine rounds
# ---------------------------------------------------------------------------
def _np_state(state):
    """A host copy of the reference's state (its jits donate the state)."""
    return jax.tree.map(lambda a: np.array(a), state)


@pytest.mark.parametrize("algo", ["fedavg", "qfedavg", "scaffold"])
@pytest.mark.parametrize("mode", ["sync", "semi_sync", "async"])
def test_engine_rounds_match_reference(small, mode, algo):
    """ROUNDS rounds of each mode (EF on, a 0.1 s deadline, 0.2 s grace,
    K = 6) from the reference's weights, round by round: cohorts, arrival
    bits and the buffer's due and tau bitwise, arrival weights, losses,
    params and buffer vectors at the stated tolerances. Then the port
    resumes from the reference's state converted after round 2 (live
    buffer entries in flight) and plays its last two rounds."""
    jdata, jnets, tdata, tnets = small
    js = JServer(_cfg("j", mode, algo=algo), jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    ts = TServer(_cfg("t", mode, algo=algo), tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    jst = js.engine.init_state(js.params)
    tst = ts.engine.init_state(ts.params)
    mid = None
    pops = late = 0
    for t in range(ROUNDS):
        if t == 2:
            mid = _np_state(jst)
        pops += int((tst.buf.due <= t).any())
        jst, jl = js.engine.run_single(jst, t)
        tst, tl = ts.engine.run_single(tst, t)
        np.testing.assert_array_equal(tl["ids"].numpy(), np.asarray(jl["ids"]))
        ta_, ja_ = tl["arrival"].numpy(), np.asarray(jl["arrival"])
        np.testing.assert_array_equal(ta_ == 1.0, ja_ == 1.0)
        np.testing.assert_array_equal(ta_ == 0.0, ja_ == 0.0)
        np.testing.assert_allclose(ta_, ja_, rtol=1e-6)
        late += int(((ta_ > 0) & (ta_ < 1)).sum())
        np.testing.assert_allclose(tl["loss"].item(), float(jl["loss"]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(tst.net.channel.numpy(),
                                      np.asarray(jst.net.channel))
        for name in ("due", "tau", "w"):
            np.testing.assert_array_equal(getattr(tst.buf, name).numpy(),
                                          np.asarray(getattr(jst.buf, name)),
                                          err_msg=f"round {t} buf.{name}")
    np.testing.assert_allclose(_vec(tst.params), _vec(jst.params),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.buf.vec.numpy(), np.asarray(jst.buf.vec),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.ef_mem.numpy(), np.asarray(jst.ef_mem),
                               rtol=1e-4, atol=1e-5)
    if mode == "sync":
        assert tst.buf.due.numel() == 0 and late == 0
    else:
        assert late > 0                       # discounted stragglers
    if mode == "async":
        assert tst.buf.due.shape == (6,)
        assert pops >= 1                      # entries landed and merged
        assert (mid.buf.due < EMPTY).any()    # in flight at round 2
    # resume from the reference's state after round 2
    rst = engine_state_from_jax(mid, "cpu")
    jfin = _np_state(jst)
    for t in (2, 3):
        rst, rl = ts.engine.run_single(rst, t)
    np.testing.assert_array_equal(rst.buf.due.numpy(), jfin.buf.due)
    np.testing.assert_array_equal(rst.buf.tau.numpy(), jfin.buf.tau)
    np.testing.assert_array_equal(rst.net.channel.numpy(), jfin.net.channel)
    np.testing.assert_allclose(_vec(rst.params), _vec(jfin.params),
                               rtol=1e-4, atol=1e-5)


PATH_CASES = {
    # the lateness memory and the bandwidth walk beside the buffer
    "staleness_aware_bw_ar1": dict(policy="staleness_aware", bw_ar1=True),
    # ARQ's airtime feeds the deadline; the FEC repair runs too
    "arq": dict(recovery=dict(policy="arq", retries=2)),
    "traced_recovery_semi_sync": dict(mode="semi_sync",
                                      recovery=dict(traced=True)),
    # AFL's mixture weights as the buffered weights
    "afl": dict(algo="afl"),
    # the candidates' debias scale from the kept fraction
    "per_client_rate": dict(debias="per_client_rate"),
    # a buffer smaller than the stragglers in flight
    "overflow_k2": dict(buffer_k=2, deadline_s=0.05),
}


@pytest.mark.parametrize("label", list(PATH_CASES))
def test_server_paths_match_reference(small, label):
    """Async (or semi_sync) beside the other subsystems, ROUNDS rounds in
    one block from the reference's weights: cohorts, channel states, the
    lateness memory and the buffer's due and tau bitwise, arrival
    weights, losses and params at the tolerances; the bandwidth levels
    rtol 1e-6 (tests/test_torch_netsim.py's), AFL's weights, and so the
    buffered weights under AFL, rtol 1e-5."""
    jdata, jnets, tdata, tnets = small
    kw = {"mode": "async", **PATH_CASES[label]}
    js = JServer(_cfg("j", **kw), jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    ts = TServer(_cfg("t", **kw), tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    jst, jl = js.engine.run_block(js.engine.init_state(js.params), 0, ROUNDS)
    tst, tl = ts.engine.run_block(ts.engine.init_state(ts.params), 0, ROUNDS)
    np.testing.assert_array_equal(tl["ids"], np.asarray(jl["ids"]))
    np.testing.assert_allclose(tl["arrival"], np.asarray(jl["arrival"]),
                               rtol=1e-6)
    assert ((tl["arrival"] > 0) & (tl["arrival"] < 1)).any()
    np.testing.assert_allclose(tl["loss"], np.asarray(jl["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tst.net.channel.numpy(),
                                  np.asarray(jst.net.channel))
    np.testing.assert_allclose(tst.net.logbw.numpy(),
                               np.asarray(jst.net.logbw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tst.stale_mem.numpy(),
                                  np.asarray(jst.stale_mem))
    for name in ("due", "tau"):
        np.testing.assert_array_equal(getattr(tst.buf, name).numpy(),
                                      np.asarray(getattr(jst.buf, name)))
    np.testing.assert_allclose(tst.buf.w.numpy(), np.asarray(jst.buf.w),
                               rtol=1e-5 if label == "afl" else 0)
    np.testing.assert_allclose(tst.buf.vec.numpy(), np.asarray(jst.buf.vec),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_vec(tst.params), _vec(jst.params),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.lam.numpy(), np.asarray(jst.lam),
                               rtol=1e-5)


def test_async_with_loose_deadline_is_bitwise_sync(small):
    """Every upload beats a 1e6 s deadline: nothing is buffered and every
    discount is w(0) = 1.0 exactly, so async and semi_sync are the port's
    sync bit for bit, as in the reference."""
    _, _, tdata, tnets = small
    outs = {}
    for mode in ("sync", "semi_sync", "async"):
        srv = TServer(_cfg("t", mode, deadline_s=1e6, rounds=5), tdata,
                      tnets, device="cpu")
        st, logs = srv.engine.run_block(srv.engine.init_state(srv.params), 0,
                                        5)
        outs[mode] = (st, logs)
    for mode in ("semi_sync", "async"):
        np.testing.assert_array_equal(_vec(outs[mode][0].params),
                                      _vec(outs["sync"][0].params))
        np.testing.assert_array_equal(outs[mode][0].ef_mem.numpy(),
                                      outs["sync"][0].ef_mem.numpy())
        np.testing.assert_array_equal(outs[mode][1]["arrival"], 1.0)
    np.testing.assert_array_equal(outs["async"][0].buf.due.numpy(), EMPTY)


@pytest.mark.parametrize("mode", ["semi_sync", "async"])
def test_empty_round_is_identity(small, mode):
    """A deadline no upload can meet (lateness pinned at MAX_LATENESS, so
    nothing is buffered either) leaves the params as they were every
    round, the buffer empty and every arrival 0."""
    _, _, tdata, tnets = small
    srv = TServer(_cfg("t", mode, deadline_s=1e-8, grace_s=1e-8, rounds=3),
                  tdata, tnets, device="cpu")
    p0 = _vec(srv.params)
    st, logs = srv.engine.run_block(srv.engine.init_state(srv.params), 0, 3)
    np.testing.assert_array_equal(_vec(st.params), p0)
    np.testing.assert_array_equal(logs["arrival"], 0.0)
    if mode == "async":
        np.testing.assert_array_equal(st.buf.due.numpy(), EMPTY)
        np.testing.assert_array_equal(st.buf.vec.numpy(), 0.0)


FAULTS = dict(enabled=True, fail_rate=0.2, flip_rate=0.2, echo_rate=0.2)


def test_async_faults_match_reference(small):
    """Async under NaN failures, sign flips and echo replays with the
    screen and the clip on (the robust uplink): cohorts, quarantine counts
    and the buffer's due and tau bitwise round by round, params and
    buffer vectors at the tolerances. A quarantined late arrival is
    refused by both packages."""
    jdata, jnets, tdata, tnets = small
    kw = dict(faults=FAULTS, defense=dict(screen=True, clip=True,
                                          clip_norm=2.0), seed=4)
    js = JServer(_cfg("j", "async", **kw), jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    ts = TServer(_cfg("t", "async", **kw), tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    jst = js.engine.init_state(js.params)
    tst = ts.engine.init_state(ts.params)
    refused = 0
    for t in range(5):
        jst, jl = js.engine.run_single(jst, t)
        tst, tl = ts.engine.run_single(tst, t)
        for name in ("ids", "quarantine"):
            np.testing.assert_array_equal(tl[name].numpy(),
                                          np.asarray(jl[name]))
        np.testing.assert_allclose(tl["arrival"].numpy(),
                                   np.asarray(jl["arrival"]), rtol=1e-6)
        arr, q = tl["arrival"].numpy(), tl["quarantine"].numpy()
        refused += int(((q > 0) & (arr > 0) & (arr < 1)).sum())
        for name in ("due", "tau", "w"):
            np.testing.assert_array_equal(getattr(tst.buf, name).numpy(),
                                          np.asarray(getattr(jst.buf, name)))
    assert refused > 0
    assert np.isfinite(tst.buf.vec.numpy()).all()
    np.testing.assert_allclose(tst.buf.vec.numpy(), np.asarray(jst.buf.vec),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_vec(tst.params), _vec(jst.params),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the traced mode grid
# ---------------------------------------------------------------------------
GRID = [(m, r) for m in t_async.MODES for r in (0.1, 0.3)]


def _grid(pkg, traced=True, rounds=5):
    return [_cfg(pkg, m, traced=traced, loss_rate=r, rounds=rounds, cpr=5)
            for m, r in GRID]


def test_traced_mode_grid_matches_reference(small):
    """The 6-cell mode x loss grid as one batched step a round against the
    reference's SweepEngine, 5 rounds: cohorts, channel states and the
    buffers' due and tau bitwise, losses, params, buffer vectors and
    arrival weights at the tolerances."""
    jdata, jnets, tdata, tnets = small
    jcfgs, tcfgs = _grid("j"), _grid("t")
    S = len(tcfgs)
    jeng = JSweep.from_configs(jcfgs, jdata, jnets)
    teng = TSweep.from_configs(tcfgs, tdata, tnets, device="cpu")
    init = [{k: np.asarray(v) for k, v in
             j_mlp_init(jax.random.PRNGKey(c.seed)).items()} for c in jcfgs]
    jst, jlogs = jeng.run_block(jeng.init_states(), 0, 5)
    tst, tlogs = teng.run_block(
        teng.init_states([params_from_jax(p, "cpu") for p in init]), 0, 5)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_array_equal(tst.net.channel.numpy(),
                                  np.asarray(jst.net.channel))
    assert tst.buf.due.shape == (S, 6)
    for name in ("due", "tau", "w"):
        np.testing.assert_array_equal(getattr(tst.buf, name).numpy(),
                                      np.asarray(getattr(jst.buf, name)))
    np.testing.assert_allclose(tlogs["arrival"], jlogs["arrival"],
                               rtol=1e-6)
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    np.testing.assert_allclose(_vec(tst.params, (S,)),
                               _vec(jst.params, (S,)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.buf.vec.numpy(), np.asarray(jst.buf.vec),
                               rtol=1e-4, atol=1e-5)
    # only the async cells buffer
    live = (tst.buf.due.numpy() < EMPTY).any(axis=1)
    np.testing.assert_array_equal(live, [m == "async" for m, _ in GRID])


def test_traced_cells_equal_static_runs(small):
    """Each traced cell is its static mode's run: cohorts, arrival bits,
    due and tau bitwise, losses and params rtol 1e-6 / atol 1e-7; and
    run_grid plays the traced grid to the sweep's losses."""
    _, _, tdata, tnets = small
    cfgs = _grid("t")
    S = len(cfgs)
    eng = TSweep.from_configs(cfgs, tdata, tnets, device="cpu")
    st, logs = eng.run_block(eng.init_states(), 0, 5)
    for i, c in enumerate(cfgs):
        srv = TServer(dataclasses.replace(
            c, srv=dataclasses.replace(c.srv, traced=False)), tdata, tnets,
            device="cpu")
        s1, l1 = srv.engine.run_block(srv.engine.init_state(srv.params), 0,
                                      5)
        np.testing.assert_array_equal(logs["ids"][i], l1["ids"])
        np.testing.assert_array_equal(logs["arrival"][i] == 1.0,
                                      l1["arrival"] == 1.0)
        np.testing.assert_allclose(logs["arrival"][i], l1["arrival"],
                                   rtol=1e-6)
        np.testing.assert_allclose(logs["loss"][i], l1["loss"], rtol=1e-6)
        np.testing.assert_allclose(_vec(st.params, (S,))[i], _vec(s1.params),
                                   rtol=1e-6, atol=1e-7)
        if c.srv.mode == "async":
            for name in ("due", "tau"):
                np.testing.assert_array_equal(
                    getattr(st.buf, name)[i].numpy(),
                    getattr(s1.buf, name).numpy())
        else:
            assert s1.buf.due.numel() == 0
    hists = t_run_grid(cfgs, tdata, tnets, device="cpu")
    np.testing.assert_allclose([[h.train_loss for h in hist] for hist in hists],
                               logs["loss"], rtol=1e-6)


@pytest.mark.parametrize("mode", ["semi_sync", "async"])
def test_static_mode_sweep_varies_alpha_and_grace(small, mode):
    """A sweep of one static mode whose cells differ in the staleness
    exponent and the grace window (the scenario knobs): each cell is its
    single run, cohorts, arrival bits, due and tau bitwise, arrival
    weights, losses and params rtol 1e-6 / atol 1e-7, and the knobs
    change the cells' arrival weights."""
    _, _, tdata, tnets = small
    knobs = ((0.5, 0.2), (1.5, 0.05), (0.0, 0.4))
    cfgs = [_cfg("t", mode, alpha=a, grace_s=g, rounds=3) for a, g in knobs]
    eng = TSweep.from_configs(cfgs, tdata, tnets, device="cpu")
    st, logs = eng.run_block(eng.init_states(), 0, 3)
    for i, c in enumerate(cfgs):
        srv = TServer(c, tdata, tnets, device="cpu")
        s1, l1 = srv.engine.run_block(srv.engine.init_state(srv.params), 0,
                                      3)
        np.testing.assert_array_equal(logs["ids"][i], l1["ids"])
        np.testing.assert_array_equal(logs["arrival"][i] == 1.0,
                                      l1["arrival"] == 1.0)
        np.testing.assert_allclose(logs["arrival"][i], l1["arrival"],
                                   rtol=1e-6)
        np.testing.assert_allclose(logs["loss"][i], l1["loss"], rtol=1e-6)
        np.testing.assert_allclose(_vec(st.params, (3,))[i], _vec(s1.params),
                                   rtol=1e-6, atol=1e-7)
        for name in ("due", "tau"):
            np.testing.assert_array_equal(getattr(st.buf, name)[i].numpy(),
                                          getattr(s1.buf, name).numpy())
    discounted = [set(np.round(logs["arrival"][i][(logs["arrival"][i] > 0)
                                                  & (logs["arrival"][i] < 1)],
                               6)) for i in range(3)]
    assert discounted[0] != discounted[1]
    if mode == "async":
        # alpha = 0: every buffered upload counts whole
        assert not discounted[2]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,traced", [("semi_sync", False),
                                         ("async", False), ("sync", True)])
def test_nonsync_requires_deadline(small, mode, traced):
    _, _, tdata, tnets = small
    cfg = _cfg("t", mode, traced=traced, deadline=False)
    with pytest.raises(ValueError, match="deadline"):
        TServer(cfg, tdata, tnets, device="cpu")
    with pytest.raises(ValueError, match="deadline"):
        TSweep.from_configs([cfg], tdata, tnets, device="cpu")


@pytest.mark.parametrize("mode,traced", [("async", False), ("sync", True)])
def test_buffer_refuses_per_coord_count(small, mode, traced):
    _, _, tdata, tnets = small
    with pytest.raises(ValueError, match="per_coord_count"):
        TServer(_cfg("t", mode, traced=traced, debias="per_coord_count"),
                tdata, tnets, device="cpu")
    # semi_sync carries no buffer and takes it
    TServer(_cfg("t", "semi_sync", debias="per_coord_count"), tdata, tnets,
            device="cpu")


@pytest.mark.parametrize("a,b", [
    (dict(mode="sync"), dict(mode="async")),
    (dict(mode="async", traced=True, buffer_k=4),
     dict(mode="async", traced=True, buffer_k=8)),
    (dict(mode="async", traced=True), dict(mode="async"))])
def test_sweep_refuses_mixed_static_srv(small, a, b):
    """The static mode, the traced flag and buffer_k must agree across a
    sweep, in the configs and in each Scenario's own ``srv``; the
    exponent and the grace window may vary."""
    _, _, tdata, tnets = small
    ca, cb = _cfg("t", **a), _cfg("t", **b)
    with pytest.raises(ValueError, match="static"):
        TSweep.from_configs([ca, cb], tdata, tnets, device="cpu")
    with pytest.raises(ValueError, match="static server"):
        TSweep(ca, [scenario_from_config(cb, tdata, tnets)], device="cpu")
    cc = _cfg("t", **a, alpha=0.9, grace_s=0.5)
    TSweep.from_configs([ca, cc], tdata, tnets, device="cpu")


# ---------------------------------------------------------------------------
# the headline
# ---------------------------------------------------------------------------
def _per_client_losses(params, data):
    dd = stage_on_device(data, "cpu")
    L = min(64, dd.train_x.shape[1])
    msk = (torch.arange(L)[None, :] < dd.counts[:, None]).float()
    return torch.func.vmap(mlp_weighted_loss, in_dims=(None, 0, 0, 0))(
        params, dd.train_x[:, :L], dd.train_y[:, :L], msk).numpy()


def _j_per_client_losses(params, data):
    from repro.core.mlp import mlp_weighted_loss as j_loss
    from repro.data.synthetic import stage_on_device as j_stage
    dd = j_stage(data)
    L = min(64, dd.train_x.shape[1])
    msk = (np.arange(L)[None, :]
           < np.asarray(dd.counts)[:, None]).astype(np.float32)
    return np.asarray(jax.vmap(j_loss, in_axes=(None, 0, 0, 0))(
        params, dd.train_x[:, :L], dd.train_y[:, :L], jnp.asarray(msk)))


def _arrival_mass(logs):
    mass = np.zeros(N_CLIENTS)
    np.add.at(mass, np.asarray(logs["ids"]).ravel(),
              np.asarray(logs["arrival"]).ravel())
    return mass


def test_async_beats_sync_under_bursty_loss_and_tight_deadline(small):
    """The reference's headline, both packages side by side: 30% bursty
    loss (burst 8) and a 0.1 s deadline, 30 rounds, K = 16. Sync gives
    the chronically late clients no arrival mass, async keeps folding
    them in; the arrival masses equal the reference's (rtol 1e-6), and
    async ends with the lower mean and slow-client losses in the port
    wherever it does in the reference."""
    jdata, jnets, tdata, tnets = small
    R = 30
    res = {}
    for mode in ("sync", "async"):
        kw = dict(rounds=R, buffer_k=16, seed=1)
        jc, tc = _cfg("j", mode, **kw), _cfg("t", mode, **kw)
        js = JServer(jc, jdata, jnets)
        init = {k: np.asarray(v) for k, v in js.params.items()}
        jst, jl = js.engine.run_block(js.engine.init_state(js.params), 0, R)
        ts = TServer(tc, tdata, tnets, device="cpu",
                     init_params=params_from_jax(init, "cpu"))
        tst, tl = ts.engine.run_block(ts.engine.init_state(ts.params), 0, R)
        np.testing.assert_array_equal(tl["ids"], np.asarray(jl["ids"]))
        res[mode] = dict(
            t_mass=_arrival_mass(tl), j_mass=_arrival_mass(jl),
            t_loss=_per_client_losses(tst.params, tdata),
            j_loss=_j_per_client_losses(jst.params, jdata))
    D = _vec(tst.params).shape[0]
    secs = t_dl.round_upload_seconds(
        -(-D // 256), 256, torch.tensor(tnets.upload_mbps, dtype=torch.float32),
        0.3, torch.tensor(ts.sufficient, dtype=torch.bool)).numpy()
    late = secs > 0.1
    assert late.sum() >= 3 and (~late).sum() >= 10
    for mode in res:
        np.testing.assert_allclose(res[mode]["t_mass"], res[mode]["j_mass"],
                                   rtol=1e-6)
    assert res["sync"]["t_mass"][late].sum() == 0.0
    assert (res["async"]["t_mass"][late] > 0).sum() >= 3
    for pkg in ("j", "t"):
        ls, la = res["sync"][f"{pkg}_loss"], res["async"][f"{pkg}_loss"]
        assert la.mean() < ls.mean(), pkg
        assert la[late].mean() < ls[late].mean(), pkg
