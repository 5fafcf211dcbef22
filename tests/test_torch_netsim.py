"""The port's network simulator against the JAX reference.

Both packages get the same numpy-seeded inputs. Tolerances:
  * bitwise: the Gilbert–Elliott masks and final states (float32
    comparisons and selects only), the channel parameter math and the
    stationary initial state (threefry draws), the AR(1) step given the
    same normals, the upload seconds and the deadline bits;
  * ``logbw_round_step`` and the engine's levels rtol 1e-6 / atol 1e-6:
    the normals go through ``erfinv``, which differs between the two
    frameworks by a few ulps, an absolute error of about 1e-7 in a level
    that may sit near zero;
  * engine runs over 5 rounds from the same weights and simulator
    state: cohorts, channel states and delivered bits bitwise, losses
    rtol 1e-5, params rtol 1e-4 / atol 1e-5 (matmuls sum in another
    order; see tests/test_torch_engine.py for why runs stop at 5).
On the CPU the mask op runs its plain version; the CUDA kernel's own
tests are in tests/test_torch_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.core.server import FederatedServer as JServer
from repro.core.server import FLConfig as JConfig
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.kernels.netsim_mask.netsim_mask import netsim_mask_call as j_call
from repro.kernels.netsim_mask.ref import ge_mask_ref as j_mask_ref
from repro.netsim import NetSimConfig as JNetSim
from repro.netsim import bandwidth as j_bw
from repro.netsim import channel as j_ch
from repro.netsim import delivery as j_dl
from repro.network import trace as j_trace
from repro_torch import prng
from repro_torch.convert import net_state_from_jax, params_from_jax
from repro_torch.core.engine import RoundScanEngine
from repro_torch.core.selection import SelectionConfig
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.kernels.netsim_mask import netsim_mask as t_nm
from repro_torch.kernels.netsim_mask import ops as t_ops
from repro_torch.kernels.netsim_mask.ref import ge_mask_ref as t_mask_ref
from repro_torch.netsim import bandwidth as t_bw
from repro_torch.netsim import channel as t_ch
from repro_torch.netsim import delivery as t_dl
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.netsim.state import init_net_state
from repro_torch.network import trace as t_trace
from repro_torch.network.packets import n_packets
from _torch_channel_cases import (GE_VARIANTS, MASK_P, SEEDS, ge_case,
                                  scan_mask)

N_CLIENTS = 20
ROUNDS = 5


def _mask_case(R, P, per_client, seed):
    rng = np.random.default_rng(seed)
    u_t = rng.random((R, P)).astype(np.float32)
    u_e = rng.random((R, P)).astype(np.float32)
    s0 = (rng.random(R) < 0.4).astype(np.int32)
    if per_client:
        rates = rng.uniform(0.05, 0.4, R).astype(np.float32)
    else:
        rates = np.float32(0.2)
    p_gb, p_bg = j_ch.ge_transition_probs(jnp.asarray(rates),
                                          jnp.float32(6.0), 0.02, 0.9)
    return u_t, u_e, s0, np.asarray(p_gb), np.asarray(p_bg)


@pytest.mark.parametrize("R", [1, 7, 10, 64])
@pytest.mark.parametrize("P", [1, 36, 129])
@pytest.mark.parametrize("per_client", [False, True])
def test_ge_packet_mask_matches_reference(R, P, per_client):
    """Masks and final states bitwise against the reference's oracle and
    its Pallas kernel in interpret mode."""
    u_t, u_e, s0, p_gb, p_bg = _mask_case(R, P, per_client, R * 1000 + P)
    before = t_nm.LAUNCHES
    m1, s1 = t_ops.ge_packet_mask(
        torch.tensor(u_t), torch.tensor(u_e), torch.tensor(s0),
        torch.tensor(p_gb), torch.tensor(p_bg), 0.02, 0.9)
    assert t_nm.LAUNCHES == before          # no kernel launch on the CPU
    assert m1.dtype == torch.float32 and s1.dtype == torch.int32

    def full(v):
        return jnp.broadcast_to(jnp.asarray(v, jnp.float32), (R,))

    args = (jnp.asarray(u_t), jnp.asarray(u_e), jnp.asarray(s0),
            full(p_gb), full(p_bg), full(0.02), full(0.9))
    m0, s0_ref = j_mask_ref(*args)
    bc = 8 if R % 8 == 0 else 1
    mk, sk = j_call(*args, block_c=bc, interpret=True)
    for m, s in ((m0, s0_ref), (mk, sk)):
        np.testing.assert_array_equal(m1.numpy(), np.asarray(m))
        np.testing.assert_array_equal(s1.numpy(), np.asarray(s))


def test_ge_packet_mask_vmap_equals_separate_calls():
    """The sweep's scenario axis: a vmapped (S, C, P) call folds the
    scenarios into the rows of one op call and equals S calls."""
    S, C, P = 3, 10, 36
    rng = np.random.default_rng(5)
    u_t = torch.tensor(rng.random((S, C, P)).astype(np.float32))
    u_e = torch.tensor(rng.random((S, C, P)).astype(np.float32))
    s0 = torch.tensor((rng.random((S, C)) < 0.3).astype(np.int32))
    p_gb = torch.tensor(rng.uniform(0.0, 0.3, S).astype(np.float32))
    p_bg = torch.tensor(rng.uniform(0.05, 0.5, (S, C)).astype(np.float32))
    m, s = torch.func.vmap(
        lambda a, b, c, g, h: t_ops.ge_packet_mask(a, b, c, g, h, 0.0,
                                                   1.0))(
        u_t, u_e, s0, p_gb, p_bg)
    assert m.shape == (S, C, P) and s.shape == (S, C)
    for i in range(S):
        mi, si = t_ops.ge_packet_mask(u_t[i], u_e[i], s0[i], p_gb[i],
                                      p_bg[i], 0.0, 1.0)
        assert torch.equal(m[i], mi) and torch.equal(s[i], si)


def test_mask_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        t_nm.netsim_mask_call(x, x, torch.zeros(2, dtype=torch.int32),
                              *[torch.zeros(2)] * 4)


def _mask_geometries(P):
    """The kernel's plan for rows of P packets, a whole warp a row and a
    narrow segment, one packet a lane and (where P allows it) four."""
    want = t_nm.plan(P, P % 4 == 0)
    out = {(want.lanes, want.vec), (32, False), (4, False)}
    if P % 4 == 0:
        out |= {(32, True), (2, True)}
    return sorted(out)


@pytest.mark.parametrize("variant", GE_VARIANTS)
@pytest.mark.parametrize("P", MASK_P)
@pytest.mark.parametrize("seed", SEEDS)
def test_mask_scan_transcription_matches_reference(seed, P, variant):
    """The kernel's scheme (32-lane segments or narrower, 1 or 4 packets
    a lane, the 2-bit map scan and the carry), transcribed in torch, is
    bitwise the reference's oracle, its Pallas kernel in interpret mode
    and the plain version, NaN uniforms and threshold ties included."""
    R = 16
    case = ge_case(R, P, seed, variant)
    jargs = tuple(jnp.asarray(a) for a in case)
    j_m, j_s = j_mask_ref(*jargs)
    k_m, k_s = j_call(*jargs, block_c=8, interpret=True)
    np.testing.assert_array_equal(np.asarray(k_m), np.asarray(j_m))
    np.testing.assert_array_equal(np.asarray(k_s), np.asarray(j_s))
    targs = tuple(torch.tensor(a) for a in case)
    p_m, p_s = t_mask_ref(*targs)
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(j_m))
    np.testing.assert_array_equal(p_s.numpy(), np.asarray(j_s))
    for lanes, vec in _mask_geometries(P):
        m, s = scan_mask(*targs, lanes=lanes, vec=vec)
        np.testing.assert_array_equal(m.numpy(), np.asarray(j_m),
                                      err_msg=f"lanes={lanes} vec={vec}")
        np.testing.assert_array_equal(s.numpy(), np.asarray(j_s),
                                      err_msg=f"lanes={lanes} vec={vec}")


@pytest.mark.parametrize("P,vec,lanes", [
    (36, True, 16), (1024, True, 32), (1, False, 1), (31, False, 32),
    (33, False, 32), (4, True, 1), (8, False, 8), (36, False, 32),
    (100, True, 32), (60, True, 16)])
def test_mask_plan_covers_a_row_in_the_fewest_lanes(P, vec, lanes):
    pl = t_nm.plan(P, vec)
    assert (pl.lanes, pl.vec, pl.threads) == (lanes, vec, t_nm.THREADS)
    assert pl.threads % 32 == 0 and pl.threads % pl.lanes == 0


class _OnCard:
    """Stands in for a tensor on the card: the refusal reads only
    ``is_cuda``, so a CPU tensor in any other slot is what it refuses."""
    is_cuda = True


_MASK_OPERANDS = ("u_t", "u_e", "s0", "p_gb", "p_bg", "h_g", "h_b")


@pytest.mark.parametrize("name", _MASK_OPERANDS)
def test_mask_call_refuses_a_cpu_operand_first(name):
    """A CPU tensor in any operand raises the CUDA refusal, named, before
    the counter moves and before the library is built or loaded; it is
    also of the wrong dtype and shape, so no later check can raise
    first."""
    ops = {k: _OnCard() for k in _MASK_OPERANDS}
    ops[name] = torch.zeros(3, dtype=torch.float64)
    before = (t_nm.LAUNCHES, t_nm._lib.cache_info())
    with pytest.raises(ValueError, match=f"CUDA tensors only, and {name} "
                                         f"lies on cpu"):
        t_nm.netsim_mask_call(*(ops[k] for k in _MASK_OPERANDS))
    assert (t_nm.LAUNCHES, t_nm._lib.cache_info()) == before


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_channel_math_and_init_bitwise(seed):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0.0, 0.6, 40).astype(np.float32)
    for hg, hb in ((0.0, 1.0), (0.02, 0.9), (0.3, 0.3)):
        for burst in (0.5, 1.0, 2.0, 8.0, 16.0):
            j = j_ch.ge_transition_probs(jnp.asarray(lr), jnp.float32(burst),
                                         jnp.float32(hg), jnp.float32(hb))
            t = t_ch.ge_transition_probs(torch.tensor(lr),
                                         torch.tensor(burst), hg, hb)
            for a, b in zip(j, t):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(
            t_ch.stationary_bad_frac(torch.tensor(lr), hg, hb).numpy(),
            np.asarray(j_ch.stationary_bad_frac(jnp.asarray(lr),
                                                jnp.float32(hg),
                                                jnp.float32(hb))))
        for rate in (np.float32(0.2), lr[:N_CLIENTS]):
            j = j_ch.init_channel_state(jax.random.PRNGKey(seed), N_CLIENTS,
                                        jnp.asarray(rate), hg, hb)
            t = t_ch.init_channel_state(prng.PRNGKey(seed), N_CLIENTS,
                                        torch.tensor(rate), hg, hb)
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_host_sampler_matches_reference():
    """The host-side numpy sampler draws the same mask from the same
    numpy generator state."""
    for args in ((16, 36, 0.2, 8.0), (5, 129, 0.3, 2.0, 0.02, 0.9)):
        a = j_ch.sample_ge_mask_numpy(np.random.default_rng(8), *args)
        b = t_ch.sample_ge_mask_numpy(np.random.default_rng(8), *args)
        np.testing.assert_array_equal(b, a)


def test_ar1_step_bitwise_and_round_step_close():
    rng = np.random.default_rng(3)
    logbw = rng.normal(2.0, 2.0, 64).astype(np.float32)
    eps = rng.normal(size=64).astype(np.float32)
    for rho in (0.0, 0.5, 0.9, 0.99):
        j = j_trace.ar1_logspeed_step(jnp.asarray(logbw), jnp.float32(rho),
                                      jnp.asarray(eps))
        t = t_trace.ar1_logspeed_step(torch.tensor(logbw),
                                      torch.tensor(rho), torch.tensor(eps))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for seed, rnd in ((0, 0), (3, 7)):
        j = j_bw.logbw_round_step(
            jax.random.fold_in(jax.random.PRNGKey(seed), rnd),
            jnp.asarray(logbw), jnp.float32(0.9))
        t = t_bw.logbw_round_step(prng.fold_in(prng.PRNGKey(seed), rnd),
                                  torch.tensor(logbw), torch.tensor(0.9))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    # the initial levels: one log, to an ulp
    speeds = rng.lognormal(2.0, 2.0, 64)
    np.testing.assert_allclose(t_bw.init_logbw(speeds).numpy(),
                               np.asarray(j_bw.init_logbw(speeds)),
                               rtol=1e-6)


def test_upload_seconds_and_deadline_bitwise():
    rng = np.random.default_rng(9)
    C = 64
    mbps = rng.lognormal(2.0, 2.0, C).astype(np.float32)
    mbps[:4] = [0.0, -1.0, np.nan, np.inf]          # degenerate speeds
    retransmit = rng.random(C) > 0.5
    for lr in (np.float32(0.2), rng.uniform(0, 1.2, C).astype(np.float32)):
        j = j_dl.round_upload_seconds(36, 256, jnp.asarray(mbps),
                                      jnp.asarray(lr),
                                      jnp.asarray(retransmit))
        t = t_dl.round_upload_seconds(36, 256, torch.tensor(mbps),
                                      torch.tensor(lr),
                                      torch.tensor(retransmit))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for dl in (0.1, 1.0, 0.0, np.nan):
            np.testing.assert_array_equal(
                t_dl.deadline_delivered(t, torch.tensor(dl,
                                                        dtype=torch.float32))
                .numpy(),
                np.asarray(j_dl.deadline_delivered(j, jnp.float32(dl))))
    assert t_dl.INFEASIBLE_SECS == j_dl.INFEASIBLE_SECS
    assert t_dl.MAX_LATENESS == j_dl.MAX_LATENESS


def test_init_net_state_and_convert():
    ns = TNetSim(channel="gilbert_elliott", bw_ar1=True)
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    st = init_net_state(ns, N_CLIENTS, device="cpu",
                        base_key=prng.PRNGKey(4),
                        loss_rate=torch.tensor(0.3), upload_mbps=speeds)
    assert st.channel.shape == (N_CLIENTS,) and st.logbw.shape == \
        (N_CLIENTS,) and st.down.shape == (0,)
    off = init_net_state(TNetSim(), N_CLIENTS, device="cpu")
    assert off.channel.shape == (0,) and off.logbw.shape == (0,)
    with pytest.raises(ValueError, match="upload speeds"):
        init_net_state(TNetSim(deadline=True), N_CLIENTS, device="cpu")
    back = net_state_from_jax(
        type("N", (), {"channel": st.channel.numpy(),
                       "logbw": st.logbw.numpy(),
                       "down": st.down.numpy()}), "cpu")
    for a, b in zip(back, st):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine with the simulator on, against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inputs():
    """tests/test_netsim.py's data with lognormal speeds, so that a
    deadline drops some clients, and per-client loss rates."""
    rng = np.random.default_rng(21)
    speeds = rng.lognormal(2.1305, 2.0351, N_CLIENTS)
    loss = rng.uniform(0.05, 0.3, N_CLIENTS)
    nets = j_trace.ClientNetworks(speeds, loss)
    tnets = t_trace.ClientNetworks(speeds, loss)
    return (j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), nets,
            t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), tnets)


def _vec(params):
    return np.concatenate([np.asarray(params[k]).ravel()
                           for k in sorted(params)])


def _configs(netsim, tra, **kw):
    common = dict(n_rounds=ROUNDS, clients_per_round=8, local_steps=4,
                  batch_size=16, eval_every=100, **kw)
    return (JConfig(tra=JTRA(**tra), netsim=JNetSim(**netsim), **common),
            TConfig(tra=TTRA(**tra), netsim=TNetSim(**netsim), **common))


def _run_both(inputs, jc, tc):
    """Both engines for ROUNDS rounds from the reference's weights and
    initial simulator state. Returns (jstate, jlogs, tstate, tlogs,
    port's initial state, port server)."""
    jdata, jnets, tdata, tnets = inputs
    js = JServer(jc, jdata, jnets)
    j0 = js.engine.init_state(js.params)
    # copies: the reference's run donates its state
    init = {k: np.array(v) for k, v in j0.params.items()}
    jnet0 = jax.tree.map(np.array, j0.net)
    jstate, jlogs = js.engine.run_block(j0, 0, ROUNDS)
    ts = TServer(tc, tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    t0 = ts.engine.init_state(ts.params)
    # the channel init is bitwise; the log of the speeds is 1 ulp off
    # at times, so start the port from the reference's levels
    np.testing.assert_array_equal(t0.net.channel.numpy(), jnet0.channel)
    t0 = t0._replace(net=net_state_from_jax(jnet0, "cpu"))
    tstate, tlogs = ts.engine.run_block(t0, 0, ROUNDS)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    np.testing.assert_allclose(_vec(tstate.params), _vec(jstate.params),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tstate.net.channel.numpy(),
                                  np.asarray(jstate.net.channel))
    if tc.error_feedback:
        np.testing.assert_allclose(tstate.ef_mem.numpy(),
                                   np.asarray(jstate.ef_mem), rtol=1e-4,
                                   atol=1e-5)
    return jstate, jlogs, tstate, tlogs, t0, ts


@pytest.mark.parametrize("algo", ["fedavg", "qfedavg"])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("per_client", [False, True])
def test_ge_rounds_match_reference(inputs, algo, ef, per_client):
    tra = dict(enabled=True, loss_rate=0.25, per_client_loss=per_client,
               debias="per_client_rate" if per_client else "group_rate")
    jc, tc = _configs(dict(channel="gilbert_elliott", burst_len=6.0,
                           good_loss=0.02, bad_loss=0.9), tra, algo=algo,
                      error_feedback=ef)
    _, jlogs, tstate, _, t0, _ = _run_both(inputs, jc, tc)
    # the cohorts' channels moved; the others kept their state
    moved = np.unique(jlogs["ids"])
    still = np.setdiff1d(np.arange(N_CLIENTS), moved)
    np.testing.assert_array_equal(tstate.net.channel.numpy()[still],
                                  t0.net.channel.numpy()[still])


def _replay_seconds(cfg, t0, ts, ids):
    """Each round's upload seconds of its cohort, replayed from the
    port's initial levels with the port's AR(1) step."""
    D = sum(v.numel() for v in t0.params.values())
    P = n_packets(D, cfg.tra.packet_floats)
    ctx = ts.engine.ctx
    logbw = t0.net.logbw
    out = []
    for t in range(ROUNDS):
        if cfg.netsim.bw_ar1:
            logbw = t_bw.logbw_round_step(prng.fold_in(ctx.base_key, t),
                                          logbw, ctx.bw_rho)
        cid = torch.tensor(ids[t])
        lr = ctx.loss_rate if ctx.loss_rate.dim() == 0 \
            else ctx.loss_rate[cid]
        out.append(t_dl.round_upload_seconds(
            P, cfg.tra.packet_floats, torch.exp(logbw[cid]), lr,
            ctx.sufficient[cid].bool()).numpy())
    return np.stack(out), logbw


@pytest.mark.parametrize("algo", ["fedavg", "qfedavg"])
@pytest.mark.parametrize("channel", ["iid", "gilbert_elliott"])
def test_ge_bw_deadline_rounds_match_reference(inputs, algo, channel):
    """GE loss, the AR(1) walk and a sync deadline that drops some
    clients: the delivered bits are bitwise the reference's."""
    deadline = 0.1
    jc, tc = _configs(dict(channel=channel, burst_len=4.0, bw_ar1=True,
                           bw_rho=0.8, deadline=True, deadline_s=deadline),
                      dict(enabled=True, loss_rate=0.2), algo=algo)
    jstate, jlogs, tstate, tlogs, t0, ts = _run_both(inputs, jc, tc)
    np.testing.assert_array_equal(tlogs["arrival"], jlogs["arrival"])
    np.testing.assert_allclose(tstate.net.logbw.numpy(),
                               np.asarray(jstate.net.logbw), rtol=1e-6,
                               atol=1e-6)
    secs, logbw = _replay_seconds(tc, t0, ts, tlogs["ids"])
    torch.testing.assert_close(logbw, tstate.net.logbw, rtol=0, atol=0)
    # the normals differ by ulps between the frameworks: no cohort
    # client may sit within that noise of the deadline
    assert np.abs(secs / deadline - 1.0).min() > 1e-4
    dropped = 1.0 - tlogs["arrival"]
    assert 0 < dropped.sum() < dropped.size      # the deadline bites


@pytest.mark.parametrize("change,error", [
    # the selection scores need their netsim model: the GE channel's
    # state, the deadline's lateness
    (dict(netsim=TNetSim(bw_ar1=True),
          sel=SelectionConfig(policy="netsim_state")), ValueError),
    (dict(netsim=TNetSim(channel="gilbert_elliott", bw_ar1=True),
          sel=SelectionConfig(policy="staleness_aware")), ValueError),
    (dict(netsim=TNetSim(channel="gilbert_elliott"),
          tra=TTRA(enabled=False)), ValueError)])
def test_unported_and_refused_netsim_configs(inputs, change, error):
    _, _, tdata, tnets = inputs
    cfg = dataclasses.replace(TConfig(n_rounds=1), **change)
    with pytest.raises(error):
        TServer(cfg, tdata, tnets, device="cpu")


def test_deadline_needs_speeds(inputs):
    _, _, tdata, _ = inputs
    cfg = TConfig(n_rounds=1, netsim=TNetSim(deadline=True))
    with pytest.raises(ValueError, match="upload_mbps"):
        RoundScanEngine(cfg, tdata, np.ones(N_CLIENTS),
                        np.ones(N_CLIENTS, bool), device="cpu")


def test_netsim_config_validates():
    with pytest.raises(ValueError):
        TNetSim(channel="markov")
    assert [f.name for f in dataclasses.fields(TNetSim)] == \
        [f.name for f in dataclasses.fields(JNetSim)]
    assert t_ch.CH_INIT_FOLD == j_ch.CH_INIT_FOLD
    assert t_bw.BW_FOLD == j_bw.BW_FOLD
