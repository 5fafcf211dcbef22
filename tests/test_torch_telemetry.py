"""The port's telemetry, event stream and program registry against the
JAX reference.

Both packages get the same numpy-seeded inputs; engine runs play each
round from the reference's state, handed over with
``convert.engine_state_from_jax``. Tolerances:
  * bitwise: the key set of every round's ``tele/...`` logs; the means
    of 0/1 masks and counts (``delivered_frac``, ``realized_loss``,
    ``quar_frac``, ``buf_fill``, ``downlink_loss``, ``fec_recovered``,
    ``arq_recovered``, ``rec_level_mean``), which XLA computes as the
    exact count times the float32 reciprocal of the size, fused with a
    following ``1 -``; the scatter-adds (``part_quartile``,
    ``stale_hist``, ``budget_escalations`` and the "full" carry; cohort
    ids are unique, so they are exact); ``bandwidth_quartiles`` against
    the reference's jitted quantile, ties included;
  * rtol 1e-6: the fp32 reductions (``update_norm``, ``ef_norm``,
    ``debias_scale_mean``) and ``arrival_mean``, whose arrival weights
    are themselves within 1 ulp of the reference's (``torch.pow``);
  * the port against itself: "off" leaves no ``tele/`` key, a zero-size
    carry and runs exactly the ops of the step before telemetry; the
    parameters of "off" and "full" runs are bitwise equal; a grid's
    records equal its cells' single runs (integer keys bitwise, the rest
    rtol 1e-6: the sweep trains the cohort in one batched GEMM), the
    scan's history the per-round engine's bitwise; a cached step the
    uncached one bitwise.
Fingerprints are taken over each package's own static key and are not
compared across packages.
"""
import dataclasses
import importlib
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import save_checkpoint as j_save
from repro.core import telemetry as j_tele
from repro.core.async_agg import AsyncConfig as JAsync
from repro.core.lossbudget import LossBudgetConfig as JBudget
from repro.core.server import FederatedServer as JServer
from repro.core.server import FLConfig as JConfig
from repro.core.server import run_grid as j_run_grid
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.netsim import DefenseConfig as JDefense
from repro.netsim import FaultConfig as JFault
from repro.netsim import NetSimConfig as JNetSim
from repro.netsim import RecoveryConfig as JRecovery
from repro.network.trace import ClientNetworks as JNets
from repro.network.trace import sample_networks as j_sample_networks
from repro.utils import events as j_events
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.core import engine as t_engine
from repro_torch.core import sweep as t_sweep
from repro_torch.core import telemetry as t_tele
from repro_torch.core.async_agg import EMPTY_DUE
from repro_torch.core.async_agg import AsyncConfig as TAsync
from repro_torch.core.engine import (_static_key, make_round_step,
                                     static_signature)
from repro_torch.core.lossbudget import LossBudgetConfig as TBudget
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.server import RoundLog
from repro_torch.core.server import run_grid as t_run_grid
from repro_torch.core.sweep import SweepEngine as TSweep
from repro_torch.core.telemetry import (ProgramRegistry, TelemetryConfig,
                                        TelemetryState)
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.kernels import _build
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.netsim.delivery import MAX_LATENESS
from repro_torch.netsim.faults import DefenseConfig as TDefense
from repro_torch.netsim.faults import FaultConfig as TFault
from repro_torch.netsim.recovery import RecoveryConfig as TRecovery
from repro_torch.network.trace import ClientNetworks as TNets
from repro_torch.network.trace import log_upload_speeds
from repro_torch.utils.events import (EventWriter, RoundRecord,
                                      fingerprint_of, load_stream)
from tests._torch_legacy_engine_v13 import (LegacyState,
                                             make_legacy_round_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLIENTS = 20
ROUNDS = 5
# keys whose values are counts, or exact means of 0/1 masks and counts
EXACT_KEYS = ("tele/delivered_frac", "tele/realized_loss",
              "tele/part_quartile", "tele/stale_hist", "tele/quar_frac",
              "tele/buf_fill", "tele/downlink_loss", "tele/fec_recovered",
              "tele/arq_recovered", "tele/budget_escalations",
              "tele/rec_level_mean")
# fp32 reductions, and the mean of arrival weights (1 ulp of torch.pow)
CLOSE_KEYS = ("tele/update_norm", "tele/ef_norm", "tele/debias_scale_mean",
              "tele/arrival_mean")
RTOL = 1e-6


@pytest.fixture(scope="module")
def inputs():
    """tests/test_telemetry.py's data and networks (N = 20, speeds 0.5
    to 20 Mbps), and the quickstart's (Synthetic(1,1), N = 30 on the FCC
    draw), in both packages."""
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    loss = np.full(N_CLIENTS, 0.05)
    rng = np.random.default_rng(0)
    qdata = j_generate(rng, n_clients=30, alpha=1.0, beta=1.0)
    qnets = j_sample_networks(rng, 30)
    return {
        "small": (j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                             alpha=0.5, beta=0.5), JNets(speeds, loss),
                  t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                             alpha=0.5, beta=0.5), TNets(speeds, loss)),
        "quickstart": (qdata, qnets,
                       t_generate(np.random.default_rng(0), n_clients=30,
                                  alpha=1.0, beta=1.0),
                       TNets(qnets.upload_mbps, qnets.packet_loss)),
    }


GE = dict(channel="gilbert_elliott", burst_len=8.0, deadline=True,
          deadline_s=60.0)
# name -> (inputs, FLConfig fields); each builds one group of keys in
ENGINE_CASES = {
    "quickstart_tra": ("quickstart", dict(
        algo="qfedavg", cpr=10, tra=dict(enabled=True, loss_rate=0.1),
        netsim=dict())),
    "ge_recovery_controller": ("small", dict(
        netsim=dict(GE, down_channel="gilbert_elliott", down_loss=0.3),
        recovery=dict(traced=True),
        lossbudget=dict(enabled=True, budget=0.05, ema=0.3))),
    "deadline_async": ("small", dict(
        ef=True, netsim=dict(GE, deadline_s=0.1),
        srv=dict(mode="async", buffer_k=6))),
    "defended_faults": ("small", dict(
        faults=dict(enabled=True, corrupt_rate=0.1, corrupt_scale=0.5,
                    fail_rate=0.1),
        defense=dict(screen=True, clip=True, clip_norm=20.0))),
    "iid_downlink": ("small", dict(
        netsim=dict(down_channel="iid", down_loss=0.3))),
    "ef": ("small", dict(ef=True, netsim=dict(channel="iid"))),
}


def _cfg(pkg, *, level="off", algo="fedavg", cpr=8, rounds=ROUNDS, seed=0,
         ef=False, tra=None, netsim=None, srv=None, faults=None,
         defense=None, recovery=None, lossbudget=None, eval_every=10 ** 6,
         engine="scan", stale_bins=8):
    """tests/test_telemetry.py's configuration in either package (``pkg``
    "j" or "t"): 2 local steps of 8, TRA 30% on the Gilbert-Elliott
    channel (burst 8) under a 60 s deadline unless told otherwise."""
    Cfg, Tra, Net, Srv, Flt, Dfn, Rec, Bud, Tel = (
        (JConfig, JTRA, JNetSim, JAsync, JFault, JDefense, JRecovery,
         JBudget, j_tele.TelemetryConfig) if pkg == "j" else
        (TConfig, TTRA, TNetSim, TAsync, TFault, TDefense, TRecovery,
         TBudget, TelemetryConfig))
    return Cfg(
        algo=algo, n_rounds=rounds, clients_per_round=cpr, local_steps=2,
        batch_size=8, lr=0.1, eval_every=eval_every, seed=seed,
        error_feedback=ef, engine=engine,
        tra=Tra(**(tra or dict(enabled=True, loss_rate=0.3))),
        netsim=Net(**(GE if netsim is None else netsim)),
        srv=Srv(**(srv or {})), faults=Flt(**(faults or {})),
        defense=Dfn(**(defense or {})), recovery=Rec(**(recovery or {})),
        lossbudget=Bud(**(lossbudget or {})),
        telemetry=Tel(level=level, stale_bins=stale_bins))


def _vec(params):
    return np.concatenate([np.asarray(params[k]).ravel()
                           for k in sorted(params)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_tele_logs(tl, jl, label):
    """The port's ``tele/`` logs against the reference's: the same keys,
    EXACT_KEYS bitwise, CLOSE_KEYS within RTOL."""
    tkeys = {k for k in tl if k.startswith("tele/")}
    jkeys = {k for k in jl if k.startswith("tele/")}
    assert tkeys == jkeys, label
    for k in tkeys:
        a, b = np.asarray(tl[k], np.float32), np.asarray(jl[k], np.float32)
        assert a.shape == b.shape, (label, k)
        if k in EXACT_KEYS:
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=f"{label} {k}")
        else:
            assert k in CLOSE_KEYS, k
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=f"{label} {k}")


def _assert_carry(tst, jst, label):
    """The "full" carry: counts bitwise; the arrival mass and lateness
    sums within RTOL (a round adds one value a client to the same
    carried value, so they are bitwise wherever the weights are)."""
    for name in ("part_count", "quar_pkts"):
        np.testing.assert_array_equal(
            _bits(getattr(tst.tele, name).numpy()),
            _bits(getattr(jst.tele, name)), err_msg=f"{label} {name}")
    for name in ("arrival_mass", "stale_sum"):
        np.testing.assert_allclose(getattr(tst.tele, name).numpy(),
                                   np.asarray(getattr(jst.tele, name)),
                                   rtol=RTOL, err_msg=f"{label} {name}")


# ---------------------------------------------------------------------------
# bandwidth quartiles
# ---------------------------------------------------------------------------
def _quartile_case(case):
    rng = np.random.default_rng(5)
    if case == "fcc_30":
        return log_upload_speeds(j_sample_networks(
            np.random.default_rng(2026), 30).upload_mbps).numpy()
    if case == "exact_21":
        # q·(N-1) = 5, 10, 15: the cuts land on elements
        return np.log(rng.lognormal(1.0, 1.0, 21)).astype(np.float32)
    if case == "n_100":
        return np.log(rng.lognormal(1.0, 1.0, 100)).astype(np.float32)
    # ties at the cuts of N = 30 (positions 7.25, 14.5 and 21.75): the
    # first between neighbours one ulp apart, where an unfused
    # interpolation rounds the cut up onto the upper one (which then
    # falls a quartile), the others between equal neighbours, which stay
    # in the lower quartile
    near = np.float32(0.64042264)

    def span(lo, hi, n):
        return rng.uniform(lo, hi, n).astype(np.float32)

    a = np.concatenate([
        span(-4.0, 0.0, 7), [near, np.nextafter(near, np.float32(np.inf))],
        span(0.7, 1.2, 5), [1.25, 1.25], span(1.3, 2.4, 5), [2.5, 2.5],
        span(2.6, 5.0, 7)]).astype(np.float32)
    return rng.permutation(a)


@pytest.mark.parametrize("case", ["fcc_30", "exact_21", "n_100", "ties"])
def test_bandwidth_quartiles_bitwise(case):
    logbw = _quartile_case(case)
    want = np.asarray(jax.jit(j_tele.bandwidth_quartiles)(jnp.asarray(logbw)))
    got = t_tele.bandwidth_quartiles(torch.from_numpy(logbw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "ties":
        # the cuts fall on tied values, which stay in the lower quartile
        cuts = np.asarray(jax.jit(lambda x: jnp.quantile(
            x, jnp.array([0.25, 0.5, 0.75], jnp.float32)))(logbw))
        assert np.isin(cuts, logbw).all()
        assert np.bincount(got.numpy()).tolist() == [8, 8, 7, 7]


def test_static_quartiles_follow_the_speeds(inputs):
    """The engine's ``sel_qid`` is the quartiles of the reference's
    ``sel_logbw`` (the FCC draw)."""
    jdata, jnets, tdata, tnets = inputs["quickstart"]
    js = JServer(_cfg("j", cpr=10), jdata, jnets)
    ts = TServer(_cfg("t", cpr=10), tdata, tnets, device="cpu")
    want = jax.jit(j_tele.bandwidth_quartiles)(js.engine.ctx.sel_logbw)
    np.testing.assert_array_equal(ts.engine.ctx.sel_qid.numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(ts.engine.ctx.sel_logbw.numpy(),
                                  np.asarray(js.engine.ctx.sel_logbw))


# ---------------------------------------------------------------------------
# round_telemetry, key by key
# ---------------------------------------------------------------------------
GATES = ("base", "quartiles", "ef", "deadline", "faults", "buffer",
         "downlink", "recovery", "controller", "all")


def _round_inputs(gate, seed=0, N=20, C=8, P=36, D=300, K=6):
    """One round's signals as numpy arrays: unique cohort ids, 0/1
    masks, random vectors, arrival weights with 0/1 and fractional
    entries, lateness up to MAX_LATENESS, quarantine counts and buffer
    dues with empty slots; the optional ones by ``gate``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    kw = dict(
        ids=rng.permutation(N)[:C].astype(np.int32),
        pkt_mask=(rng.random((C, P)) > 0.3).astype(f32),
        loss_mask=(rng.random((C, P)) > 0.2).astype(f32),
        old_vec=rng.standard_normal(D).astype(f32),
        new_vec=rng.standard_normal(D).astype(f32),
        scale=rng.random(C).astype(f32))
    on = (lambda g: gate in (g, "all"))
    opt = {}
    if on("quartiles"):
        opt["logbw"] = np.log(rng.lognormal(1.0, 1.0, N)).astype(f32)
    if on("ef"):
        opt["ef_new_rows"] = rng.standard_normal((C, D)).astype(f32)
    if on("deadline"):
        arr = rng.random(C).astype(f32)
        arr[:2], arr[2:4] = 1.0, 0.0
        late = (rng.random(C) * 12).astype(f32)
        late[0], late[1] = 0.0, MAX_LATENESS
        opt.update(arrival=arr, lateness=late)
    if on("faults"):
        opt["qcnt"] = rng.integers(0, P, C).astype(f32)
    if on("buffer"):
        due = (rng.random(K) * 10).astype(f32)
        due[::2] = EMPTY_DUE
        opt["buf_due"] = due
    if on("downlink"):
        opt["down_frac"] = f32(rng.random())
    if on("recovery"):
        opt.update(fec_frac=f32(rng.random()), arq_frac=f32(rng.random()))
    if on("controller"):
        opt.update(bud_escal=f32(3.0), bud_level=f32(rng.random() * 2))
    return kw, opt


@pytest.mark.parametrize("level", ["scalars", "full"])
@pytest.mark.parametrize("gate", GATES)
def test_round_telemetry_matches_reference(gate, level):
    """``round_telemetry`` against the reference's, jitted as in its
    step, on the same signals: the same keys for each gate (an absent
    signal is an absent key), EXACT_KEYS bitwise, the rest within RTOL;
    the "full" carry bitwise, the "scalars" carry passed through."""
    kw, opt = _round_inputs(gate)
    N = 20
    tcfg_j, tcfg_t = j_tele.TelemetryConfig(level), TelemetryConfig(level)
    carry = [np.random.default_rng(1).random(N if level == "full" else 0)
             .astype(np.float32) for _ in range(4)]
    logbw = opt.pop("logbw", None)

    def jfn(tele, kw, opt, logbw):
        return j_tele.round_telemetry(
            tcfg_j, j_tele.TelemetryState(*tele), n_clients=N, logbw=logbw,
            buf_empty_due=EMPTY_DUE, **kw, **opt)

    jl, jt = jax.jit(jfn)(carry, kw, opt, logbw)
    tl, tt = t_tele.round_telemetry(
        tcfg_t, TelemetryState(*(torch.from_numpy(c) for c in carry)),
        n_clients=N, buf_empty_due=EMPTY_DUE,
        qid=None if logbw is None
        else t_tele.bandwidth_quartiles(torch.from_numpy(logbw)),
        **{k: torch.from_numpy(v) for k, v in kw.items()},
        **{k: torch.as_tensor(v) for k, v in opt.items()})
    _assert_tele_logs({k: v.numpy() for k, v in tl.items()}, jl,
                      f"{gate}/{level}")
    for name, a, b in zip(TelemetryState._fields, tt, jt):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                      err_msg=name)
    if level == "scalars":
        assert all(a.shape == (0,) for a in tt)


# ---------------------------------------------------------------------------
# the engine, 5 rounds against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("level", ["scalars", "full"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_telemetry_matches_reference(inputs, case, level):
    """5 rounds, each from the reference's state: every round's ``tele/``
    keys against the reference's (the same set, EXACT_KEYS bitwise,
    CLOSE_KEYS within RTOL), cohorts bitwise, and at "full" the carry."""
    which, kw = ENGINE_CASES[case]
    jdata, jnets, tdata, tnets = inputs[which]
    js = JServer(_cfg("j", level=level, **kw), jdata, jnets)
    ts = TServer(_cfg("t", level=level, **kw), tdata, tnets, device="cpu")
    jst = js.engine.init_state(js.params)
    seen = set()
    for t in range(ROUNDS):
        tst = engine_state_from_jax(jst, "cpu")   # before jax donates it
        jst, jl = js.engine.run_block(jst, t, 1)
        tst, tl = ts.engine.run_block(tst, t, 1)
        np.testing.assert_array_equal(tl["ids"], np.asarray(jl["ids"]))
        _assert_tele_logs(tl, jl, f"{case} round {t}")
        if level == "full":
            _assert_carry(tst, jst, f"{case} round {t}")
        else:
            assert all(v.shape == (0,) for v in tst.tele)
        seen |= set(tl)
    want = {"quickstart_tra": {"tele/part_quartile"},
            "ge_recovery_controller": {
                "tele/fec_recovered", "tele/arq_recovered",
                "tele/budget_escalations", "tele/rec_level_mean",
                "tele/downlink_loss", "tele/stale_hist"},
            "deadline_async": {"tele/arrival_mean", "tele/stale_hist",
                               "tele/buf_fill", "tele/ef_norm"},
            "defended_faults": {"tele/quar_frac"},
            "iid_downlink": {"tele/downlink_loss"},
            "ef": {"tele/ef_norm"}}[case]
    assert want <= seen, want - seen


# ---------------------------------------------------------------------------
# the "off" level
# ---------------------------------------------------------------------------
class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("setting", ["tra_off", "ge_deadline_ef", "faults"])
def test_off_runs_the_step_before_telemetry_op_for_op(inputs, setting):
    """At "off" (the default) a round dispatches exactly the ops of the
    step frozen before the later subsystems
    (``tests/_torch_legacy_engine_v13.py``), one for one, and leaves no
    ``tele/`` key and a zero-size carry of four distinct buffers."""
    _, _, tdata, tnets = inputs["small"]
    kw = {"tra_off": dict(tra=dict(enabled=False), netsim=dict()),
          "ge_deadline_ef": dict(ef=True),
          "faults": dict(faults=dict(enabled=True, corrupt_rate=0.1,
                                     corrupt_scale=0.5),
                         defense=dict(screen=True, clip=True,
                                      clip_norm=20.0))}[setting]
    cfg = _cfg("t", **kw)
    srv = TServer(cfg, tdata, tnets, device="cpu")
    eng = srv.engine
    st = eng.init_state(srv.params)
    assert all(v.shape == (0,) for v in st.tele)
    assert len({v.data_ptr() for v in st.tele}) == 4 or \
        all(v.numel() == 0 for v in st.tele)
    legacy = make_legacy_round_step(cfg, eng.cohort)
    old = LegacyState(*st[:6])
    for t in range(2):
        with _OpCounter() as new_ops:
            st, lg = eng.run_single(st, t)
        with _OpCounter() as old_ops:
            old, lo = legacy(eng.ctx, old, t)
        assert new_ops.ops == old_ops.ops
        assert not [k for k in lg if k.startswith("tele/")]
        np.testing.assert_array_equal(_bits(_vec(st.params)),
                                      _bits(_vec(old.params)))


@pytest.mark.parametrize("level", ["scalars", "full"])
def test_telemetry_leaves_the_training_math_alone(inputs, level):
    """Any level leaves losses, cohorts and params bitwise those of the
    "off" run: telemetry reads, never writes."""
    _, _, tdata, tnets = inputs["small"]
    out = {}
    for lv in ("off", level):
        srv = TServer(_cfg("t", level=lv, ef=True), tdata, tnets,
                      device="cpu")
        st, lg = srv.engine.run_block(srv.engine.init_state(srv.params), 0,
                                      ROUNDS)
        out[lv] = (st, lg)
    (soff, loff), (son, lon) = out["off"], out[level]
    np.testing.assert_array_equal(loff["loss"], lon["loss"])
    np.testing.assert_array_equal(loff["ids"], lon["ids"])
    np.testing.assert_array_equal(_bits(_vec(soff.params)),
                                  _bits(_vec(son.params)))
    np.testing.assert_array_equal(_bits(soff.ef_mem.numpy()),
                                  _bits(son.ef_mem.numpy()))
    assert {"tele/delivered_frac", "tele/realized_loss",
            "tele/update_norm"} <= set(lon)


def test_level_is_static_structure():
    """off, scalars and full are three step keys and three fingerprints;
    the stale histogram's size is structure too."""
    keys = {lv: _static_key(_cfg("t", level=lv))
            for lv in ("off", "scalars", "full")}
    assert len(set(keys.values())) == 3
    assert len({fingerprint_of(k) for k in keys.values()}) == 3
    sigs = [static_signature(_cfg("t", level=lv))
            for lv in ("off", "scalars", "full")]
    assert sigs[0] != sigs[1] != sigs[2] != sigs[0]
    assert _static_key(_cfg("t", level="full", stale_bins=4)) \
        != keys["full"]


def test_full_level_accumulates_per_client(inputs):
    _, _, tdata, tnets = inputs["small"]
    cfg = _cfg("t", level="full", rounds=6)
    srv = TServer(cfg, tdata, tnets, device="cpu")
    srv.run()
    stats = t_tele.final_client_stats(srv._state.tele)
    assert stats["part_count"].shape == (N_CLIENTS,)
    assert stats["part_count"].sum() == cfg.n_rounds * cfg.clients_per_round
    assert np.all(stats["arrival_mass"][stats["part_count"] == 0] == 0)
    with pytest.raises(ValueError, match="level='full'"):
        t_tele.final_client_stats(t_tele.init_telemetry_state(
            TelemetryConfig(), N_CLIENTS))


# ---------------------------------------------------------------------------
# the sweep: one program, records equal the unswept runs'
# ---------------------------------------------------------------------------
def _assert_records(got, want, label):
    """RoundRecords field by field: ints and integer-valued fields
    bitwise, the float signals within RTOL."""
    assert len(got) == len(want), label
    exact = {k.split("/")[1] for k in EXACT_KEYS} | {"round", "scenario",
                                                      "cohort"}
    for a, b in zip(got, want):
        da, db = a.to_json(), b.to_json()
        assert da.keys() == db.keys(), label
        for k in da:
            if k in exact:
                assert da[k] == db[k], (label, a.round, k)
            else:
                np.testing.assert_allclose(da[k], db[k], rtol=RTOL,
                                           err_msg=f"{label} {a.round} {k}")


def test_sweep_one_program_and_records_match_unswept(inputs, tmp_path):
    """A 2-cell loss-rate grid at "full" through run_grid(events=...):
    one sweep step built, its records equal each cell's FederatedServer
    run and the reference's run_grid records; client_stats per cell."""
    jdata, jnets, tdata, tnets = inputs["small"]
    t_tele.REGISTRY.reset()
    cfgs = {pkg: [dataclasses.replace(
        c, tra=dataclasses.replace(c.tra, loss_rate=r))
        for c in [_cfg(pkg, level="full", rounds=4, eval_every=2)]
        for r in (0.1, 0.3)] for pkg in ("j", "t")}
    path = str(tmp_path / "grid.jsonl")
    t_run_grid(cfgs["t"], tdata, tnets, device="cpu", events=path)
    assert t_tele.REGISTRY.programs_for("sweep") == 1
    t_tele.REGISTRY.assert_unique()
    _, grid_rounds, programs = load_stream(path)
    assert len(grid_rounds) == 2 * 4
    assert any(p.get("cache") == "sweep" for p in programs)
    stats = [json.loads(line) for line in open(path)
             if '"client_stats"' in line]
    assert [s["scenario"] for s in stats] == [0, 1]
    assert all(sum(s["part_count"]) == 4 * 8 for s in stats)

    jpath = str(tmp_path / "jgrid.jsonl")
    j_run_grid(cfgs["j"], jdata, jnets, events=jpath)
    _, j_rounds, _ = j_events.load_stream(jpath)
    _assert_records(grid_rounds, [RoundRecord(**dataclasses.asdict(r))
                                  for r in j_rounds], "grid vs reference")
    for s, cfg in enumerate(cfgs["t"]):
        single = str(tmp_path / f"single{s}.jsonl")
        TServer(cfg, tdata, tnets, device="cpu").run(events=single)
        _, single_rounds, _ = load_stream(single)
        mine = [dataclasses.replace(r, scenario=0) for r in grid_rounds
                if r.scenario == s]
        _assert_records(mine, single_rounds, f"cell {s}")


def test_sweep_rejects_mixed_telemetry_levels(inputs):
    _, _, tdata, tnets = inputs["small"]
    with pytest.raises(ValueError, match="static field"):
        TSweep.from_configs([_cfg("t"), _cfg("t", level="scalars")], tdata,
                            tnets, device="cpu")


@pytest.mark.parametrize("level", ["off", "full"])
def test_scan_history_matches_per_round_engine(inputs, level, tmp_path):
    """The block-flushed history and event records equal the per_round
    engine's, field for field."""
    _, _, tdata, tnets = inputs["small"]
    paths, hists = {}, {}
    for engine in ("scan", "per_round"):
        paths[engine] = str(tmp_path / f"{engine}.jsonl")
        hists[engine] = TServer(
            _cfg("t", level=level, rounds=6, eval_every=3, engine=engine),
            tdata, tnets, device="cpu").run(events=paths[engine])
    assert len(hists["scan"]) == len(hists["per_round"]) == 6
    for a, b in zip(hists["scan"], hists["per_round"]):
        assert isinstance(a, RoundLog)
        assert (a.round, a.train_loss) == (b.round, b.train_loss)
        assert (a.report is None) == (b.report is None)
        if a.report is not None:
            assert a.report.as_dict() == b.report.as_dict()
    recs = {e: load_stream(p)[1] for e, p in paths.items()}
    assert recs["scan"] == recs["per_round"]
    if level == "full":
        assert all(r.delivered_frac is not None for r in recs["scan"])
    else:
        assert all(r.delivered_frac is None for r in recs["scan"])


# ---------------------------------------------------------------------------
# checkpoint: the tele carry is an ordinary carry
# ---------------------------------------------------------------------------
def test_tele_carry_checkpoint_round_trip(inputs, tmp_path):
    _, _, tdata, tnets = inputs["small"]
    srv = TServer(_cfg("t", level="full", rounds=3), tdata, tnets,
                  device="cpu")
    srv.run()
    state = srv._state
    assert state.tele.part_count.shape == (N_CLIENTS,)
    path = save_checkpoint(str(tmp_path / "ck"), state, step=3)
    with np.load(path + ".npz") as f:
        assert {f".tele/.{n}" for n in TelemetryState._fields} <= set(f.files)
    restored, step = load_checkpoint(path, state)
    assert step == 3
    for name in TelemetryState._fields:
        np.testing.assert_array_equal(
            _bits(getattr(state.tele, name).numpy()),
            _bits(getattr(restored.tele, name).numpy()), err_msg=name)


def test_reference_full_checkpoint_resumes(inputs, tmp_path):
    """The reference's checkpoint after 2 "full" rounds under the deadline
    loads into the port's state; rounds 2 and 3 from it match the
    reference's: cohorts, tele logs and the carry."""
    jdata, jnets, tdata, tnets = inputs["small"]
    js = JServer(_cfg("j", level="full"), jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    jst, _ = js.engine.run_block(js.engine.init_state(js.params), 0, 2)
    path = str(tmp_path / "ref_ck")
    j_save(path, jst, step=2)
    ts = TServer(_cfg("t", level="full"), tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    st, step = load_checkpoint(path, ts.engine.init_state(ts.params))
    assert step == 2
    _assert_carry(st, jst, "restored")
    assert st.tele.part_count.sum() == 2 * 8
    for t in (2, 3):
        jst, jl = js.engine.run_block(jst, t, 1)
        st, tl = ts.engine.run_block(st, t, 1)
        np.testing.assert_array_equal(tl["ids"], np.asarray(jl["ids"]))
        _assert_tele_logs(tl, jl, f"resumed round {t}")
        _assert_carry(st, jst, f"resumed round {t}")


# ---------------------------------------------------------------------------
# the program registry and the step cache
# ---------------------------------------------------------------------------
def test_registry_logs_every_lookup_and_asserts_uniqueness(inputs):
    _, _, tdata, tnets = inputs["small"]
    t_tele.REGISTRY.reset()
    cfg_a, cfg_b = _cfg("t"), _cfg("t", level="scalars")
    fp = fingerprint_of((_static_key(cfg_a), cfg_a.clients_per_round))
    TServer(cfg_a, tdata, tnets, device="cpu")
    st = t_tele.REGISTRY.get("engine", fp)
    assert st is not None and st.hits + st.misses == 1
    TServer(cfg_a, tdata, tnets, device="cpu")
    assert t_tele.REGISTRY.get("engine", fp).hits >= 1
    TServer(cfg_b, tdata, tnets, device="cpu")
    fps = {fp for (kind, fp) in t_tele.REGISTRY._stats if kind == "engine"}
    assert len(fps) == 2
    t_tele.REGISTRY.assert_unique()


def test_registry_raises_on_fingerprint_collision():
    reg = ProgramRegistry()
    fp = reg.record_lookup("engine", ("key-a",), hit=False)
    reg._stats[("engine", fp)].key_repr = repr(("key-b",))
    with pytest.raises(RuntimeError, match="collision"):
        reg.record_lookup("engine", ("key-a",), hit=True)
    reg._stats[("sweep", fp)] = t_tele.ProgramStat(fp, "sweep", "key-c")
    with pytest.raises(RuntimeError, match="two static keys"):
        reg.assert_unique()


def test_timed_program_books_dispatches(monkeypatch):
    """Every call is timed and counted; a call during which a kernel
    library was built or loaded counts as a compile; attributes fall
    through to the wrapped function."""
    monkeypatch.setattr(_build, "_LOADED", {})

    def fn(x, load=False):
        if load:
            _build._LOADED["stand_in"] = None
        return x * 2

    fn.probe = "through"
    timed = t_tele.TimedProgram(fn, "engine", "deadbeef")
    t_tele.REGISTRY.reset()
    assert timed(torch.ones(4), load=True).sum() == 8
    timed(torch.ones(4))
    timed(torch.ones(4))
    st = t_tele.REGISTRY.get("engine", "deadbeef")
    assert (st.calls, st.compiles) == (3, 1)
    assert st.compile_seconds > 0 and st.exec_seconds > 0
    assert timed.probe == "through"


def test_cached_step_equals_uncached(inputs):
    """Two engines whose configs differ in sweep-varying fields only
    (seed, loss rate) share one cached step (a registry hit); the second
    engine's rounds equal bit for bit those of a step built for it
    alone."""
    _, _, tdata, tnets = inputs["small"]
    t_tele.REGISTRY.reset()
    cfg_a = _cfg("t", level="full", ef=True)
    cfg_b = dataclasses.replace(cfg_a, seed=3, tra=dataclasses.replace(
        cfg_a.tra, loss_rate=0.2))
    TServer(cfg_a, tdata, tnets, device="cpu")
    srv = TServer(cfg_b, tdata, tnets, device="cpu")
    fp = fingerprint_of((_static_key(cfg_b), cfg_b.clients_per_round))
    st = t_tele.REGISTRY.get("engine", fp)
    assert st.hits >= 1 and st.hits + st.misses == 2
    assert srv.engine._step is t_engine._STEP_CACHE[
        (_static_key(cfg_b), cfg_b.clients_per_round)][0]
    own = make_round_step(cfg_b, srv.engine.cohort)
    a = b = srv.engine.init_state(srv.params)
    for t in range(3):
        a, la = srv.engine.run_single(a, t)
        b, lb = own(srv.engine.ctx, b, t)
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k].numpy(), lb[k].numpy())
        np.testing.assert_array_equal(_bits(_vec(a.params)),
                                      _bits(_vec(b.params)))
        for x, y in zip(a.tele, b.tele):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert t_tele.REGISTRY.get("engine", fp).calls == 3


def test_sweep_cache_is_keyed_by_dataset_layout(inputs):
    """A shared dataset and a stacked one are two sweep steps."""
    _, _, tdata, tnets = inputs["small"]
    t_tele.REGISTRY.reset()
    cfgs = [_cfg("t", seed=s) for s in (0, 1)]
    TSweep.from_configs(cfgs, tdata, tnets, device="cpu")
    TSweep.from_configs(cfgs, tdata, tnets, device="cpu")
    assert t_tele.REGISTRY.programs_for("sweep") == 1
    other = t_generate(np.random.default_rng(1), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5)
    TSweep.from_configs(cfgs, [tdata, other], tnets, device="cpu")
    assert t_tele.REGISTRY.programs_for("sweep") == 2
    assert len(t_sweep._SWEEP_CACHE) >= 2


# ---------------------------------------------------------------------------
# the event stream
# ---------------------------------------------------------------------------
def test_event_writer_round_trip(tmp_path):
    """Both packages' load_stream read the port's stream; absent fields
    stay None; the registry's kind does not clobber the event tag; the
    stamp has the reference's keys, jax None, and the port's."""
    path = str(tmp_path / "ev.jsonl")
    rec = RoundRecord(round=0, scenario=1, train_loss=1.5,
                      delivered_frac=0.9, cohort=[3, 1],
                      part_quartile=[0.5, 0.25, 0.25, 0.0])
    with EventWriter(path, config_fingerprint="abc123",
                     meta={"n_rounds": 2}, device="cpu") as w:
        w.write_round(rec)
        w.write_round(RoundRecord(round=1, scenario=1, train_loss=1.2))
        w.write_program_stats([{"fingerprint": "abc123", "kind": "engine",
                                "hits": 1}])
    for load in (load_stream, j_events.load_stream):
        header, rounds, programs = load(path)
        assert header["config_fingerprint"] == "abc123"
        assert header["meta"] == {"n_rounds": 2}
        assert [r.to_json() for r in rounds] == [
            rec.to_json(), {"round": 1, "scenario": 1, "train_loss": 1.2}]
        assert rounds[1].delivered_frac is None
        assert programs[0]["kind"] == "program"
        assert programs[0]["cache"] == "engine"
    env = header["env"]
    assert {"git", "platform", "python", "time", "jax",
            "backend"} <= set(env)
    assert env["jax"] is None and env["backend"] == "cpu"
    assert env["torch"] == torch.__version__ and env["device"] == "cpu"


def test_event_writer_enforces_monotonic_rounds(tmp_path):
    with EventWriter(str(tmp_path / "ev.jsonl")) as w:
        w.write_round(RoundRecord(round=3, scenario=0))
        w.write_round(RoundRecord(round=2, scenario=1))
        with pytest.raises(ValueError, match="non-monotonic"):
            w.write_round(RoundRecord(round=3, scenario=0))


def test_load_stream_rejects_streams_without_header(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "round", "round": 0}) + "\n")
    with pytest.raises(ValueError, match="no header"):
        load_stream(path)
    with open(path, "a") as f:
        f.write("{not json\n")
    with pytest.raises(ValueError, match="malformed"):
        load_stream(path)


def test_records_from_logs_match_reference():
    """Both layouts, every key, on the same numpy logs: the port's
    records equal the reference's."""
    rng = np.random.default_rng(0)
    k = 3
    single = {"loss": rng.random(k).astype(np.float32),
              "ids": rng.integers(0, 20, (k, 4)).astype(np.int32),
              "arrival": rng.random((k, 4)).astype(np.float32)}
    for key in t_tele._SCALAR_KEYS:
        single[key] = rng.random(k).astype(np.float32)
    single["tele/part_quartile"] = rng.random((k, 4)).astype(np.float32)
    single["tele/stale_hist"] = rng.integers(0, 4, (k, 8)).astype(
        np.float32)
    stacked = {key: np.stack([v, v[::-1]]) for key, v in single.items()}
    for logs, kw in ((single, dict(t0=10)),
                     (stacked, dict(t0=4, scenario0=2)),
                     (stacked, dict(with_cohort=False))):
        got = t_tele.records_from_logs(logs, **kw)
        want = j_tele.records_from_logs(logs, **kw)
        assert [r.to_json() for r in got] == [r.to_json() for r in want]
    recs = t_tele.records_from_logs({"loss": single["loss"]})
    assert recs[0].realized_loss is None and recs[0].cohort is None


def _flstat():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    return importlib.import_module("flstat")


def test_flstat_renders_a_port_stream(inputs, tmp_path):
    """A port stream (the quickstart's data, so the quartile line shows)
    renders with tools/flstat.py as it is: summary, --rounds,
    --programs, --json, exit 0 each."""
    _, _, tdata, tnets = inputs["quickstart"]
    cfg = _cfg("t", level="full", cpr=10, rounds=4, eval_every=2)
    path = str(tmp_path / "ev.jsonl")
    TServer(cfg, tdata, tnets, device="cpu").run(events=path)
    flstat = _flstat()
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert flstat.main([path]) == 0
    out = buf.getvalue()
    assert "scenario 0" in out and "jax None [cpu]" in out
    assert "cohort share by bandwidth quartile" in out
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert flstat.main([path, "--json"]) == 0
    sc = json.loads(buf.getvalue())["scenarios"]["0"]
    assert sc["rounds"] == cfg.n_rounds
    assert sc["delivered_frac"] is not None
    assert abs(sum(sc["part_quartile"]) - 1.0) < 1e-6
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert flstat.main([path, "--rounds"]) == 0
        assert flstat.main([path, "--programs"]) == 0
    assert "engine" in buf.getvalue()


def test_telemetry_grid_example_streams_the_bias_signal(tmp_path):
    """examples/telemetry_grid_torch.py on the CPU for 2 rounds: the
    24-cell grid's stream loads, every cell's quartile shares sum to 1
    and the uniform cell gives the slowest quartile more than the hard
    threshold does."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    example = importlib.import_module("telemetry_grid_torch")
    path = str(tmp_path / "grid.jsonl")
    with redirect_stdout(io.StringIO()):
        shares = example.main(["--device", "cpu", "--rounds", "2",
                               "--events", path])
    _, rounds, programs = load_stream(path)
    assert len(rounds) == 24 * 2 and programs
    np.testing.assert_allclose(shares.sum(axis=1), 1.0, rtol=1e-6)
    policies = [c.sel.policy for c in example.grid(2)]
    uni = policies.index("uniform")
    thr = policies.index("bandwidth_threshold")
    assert shares[uni, 0] > shares[thr, 0]
