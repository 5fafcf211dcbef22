"""The port's fault model and defended round against the JAX reference.

Tolerances:
  * bitwise: the client injectors from the same key and rows, the packet
    injector with bit flips only (their draws are the threefry uniforms,
    bitwise ``jax.random``), ``flip_bit`` under vmap against its loop,
    and in the engine runs the cohorts and the quarantine counts (they
    depend on those uniforms and on finiteness alone);
  * the packet injector with Gaussian corruption: the untouched floats
    bitwise, the corrupted ones within 1e-6 relative to the corruption's
    scale (``prng.normal`` is 3 ulps from ``jax.random.normal``);
  * the 6-cell fault grid against the reference's sweep, 4 rounds from
    the reference's state: losses rtol 1e-5, params and EF memory rtol
    1e-4 / atol 1e-5 (tests/test_torch_engine.py's engine tolerances;
    matmuls sum in another order), the echo memory atol 1e-4 (one
    client's local model each, see the test);
  * the port against itself: sweep cells against single runs bitwise,
    and the neutral lock (faults on at zero rates against faults off)
    bitwise for fedavg in every debias mode, 1e-6 for qfedavg (as in the
    reference's own lock).
The headline is the reference's: 10% Gaussian corruption and 10% NaN
failures on 30% bursty Gilbert–Elliott loss, 40 rounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.core.server import FLConfig as JConfig
from repro.core.sweep import SweepEngine as JSweep
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.netsim import DefenseConfig as JDefense
from repro.netsim import FaultConfig as JFault
from repro.netsim import NetSimConfig as JNetSim
from repro.netsim import inject_client_faults as j_inject_client
from repro.netsim import inject_packet_faults as j_inject_packet
from repro.network.trace import ClientNetworks as JNets
from repro_torch import prng
from repro_torch.convert import engine_state_from_jax
from repro_torch.core.engine import _static_key
from repro_torch.core.mlp import mlp_weighted_loss
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.sweep import SweepEngine as TSweep
from repro_torch.core.tra import DEBIAS_MODES
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.data.synthetic import stage_on_device
from repro_torch.netsim import faults as t_faults
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.netsim.faults import DefenseConfig as TDefense
from repro_torch.netsim.faults import FaultConfig as TFault
from repro_torch.network.trace import ClientNetworks as TNets
from repro_torch.utils.guards import (NonFiniteError, all_finite_tree,
                                      assert_finite_tree)

N_CLIENTS = 20


@pytest.fixture(scope="module")
def inputs():
    """tests/test_faults.py's data and networks, in both packages."""
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    loss = np.full(N_CLIENTS, 0.05)
    return dict(
        jdata=j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                         alpha=0.5, beta=0.5), jnets=JNets(speeds, loss),
        tdata=t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                         alpha=0.5, beta=0.5), tnets=TNets(speeds, loss))


def _cfg(pkg="t", *, algo="fedavg", ef=False, rounds=4, cpr=8, seed=0,
         debias="group_rate", local_steps=2, batch_size=8, faults=None,
         defense=None):
    """tests/test_faults.py's ``_cfg`` in either package."""
    Cfg, Tra, Net, Flt, Dfn = (
        (JConfig, JTRA, JNetSim, JFault, JDefense) if pkg == "j"
        else (TConfig, TTRA, TNetSim, TFault, TDefense))
    return Cfg(
        algo=algo, n_rounds=rounds, clients_per_round=cpr,
        local_steps=local_steps, batch_size=batch_size, lr=0.1,
        eval_every=10 ** 6, seed=seed, error_feedback=ef,
        tra=Tra(enabled=True, loss_rate=0.3, debias=debias),
        netsim=Net(channel="gilbert_elliott", burst_len=8.0, deadline=True,
                   deadline_s=60.0),
        faults=Flt(**(faults or {})), defense=Dfn(**(defense or {})))


def _vec(params, s=None):
    return np.concatenate([np.asarray(params[k] if s is None
                                      else params[k][s]).ravel()
                           for k in sorted(params)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# injectors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rates", [
    dict(fail_rate=0.0, flip_rate=0.0, echo_rate=0.0),
    dict(fail_rate=1.0, flip_rate=0.0, echo_rate=0.0),
    dict(fail_rate=0.0, flip_rate=1.0, echo_rate=0.0),
    dict(fail_rate=0.0, flip_rate=0.0, echo_rate=1.0),
    dict(fail_rate=0.3, flip_rate=0.5, echo_rate=0.5)])
def test_client_injector_matches_reference(rates):
    C, D = 6, 17
    rng = np.random.default_rng(2)
    flat = rng.normal(size=(C, D)).astype(np.float32)
    echo = rng.normal(size=(C, D)).astype(np.float32)
    j = j_inject_client(jax.random.PRNGKey(1), jnp.asarray(flat),
                        jnp.asarray(echo),
                        **{k: jnp.float32(v) for k, v in rates.items()})
    t = t_faults.inject_client_faults(
        prng.PRNGKey(1), torch.tensor(flat), torch.tensor(echo),
        **{k: torch.tensor(v) for k, v in rates.items()})
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))
    if not any(rates.values()):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(flat))


def _packet_case():
    rng = np.random.default_rng(6)
    C, P, F = 4, 6, 32
    return (rng.normal(size=(C, P, F)).astype(np.float32),
            (rng.random((C, P)) < 0.6).astype(np.float32))


def _packet_pair(xp, mask, seed, **rates):
    j = np.asarray(j_inject_packet(
        jax.random.PRNGKey(seed), jnp.asarray(xp), jnp.asarray(mask),
        **{k: jnp.float32(v) for k, v in rates.items()}))
    t = t_faults.inject_packet_faults(
        prng.PRNGKey(seed), torch.tensor(xp), torch.tensor(mask),
        **{k: torch.tensor(v) for k, v in rates.items()}).numpy()
    return j, t


@pytest.mark.parametrize("seed", [4, 8])
def test_packet_injector_bit_flips_are_bitwise(seed):
    xp, mask = _packet_case()
    j, t = _packet_pair(xp, mask, seed, corrupt_rate=0.0,
                        corrupt_scale=1.0, bitflip_rate=0.7)
    np.testing.assert_array_equal(_bits(t), _bits(j))
    assert (t != xp).sum() > 0


@pytest.mark.parametrize("seed", [4, 8])
def test_packet_injector_corruption_matches_reference(seed):
    xp, mask = _packet_case()
    scale = 3.0
    j, t = _packet_pair(xp, mask, seed, corrupt_rate=0.5,
                        corrupt_scale=scale, bitflip_rate=0.3)
    same = _bits(j) == _bits(xp)
    np.testing.assert_array_equal(_bits(t)[same], _bits(j)[same])
    hit = (~same).reshape(xp.shape[0], xp.shape[1], -1).any(-1)
    assert hit.any() and not hit.all()
    np.testing.assert_allclose(t[~same], j[~same], rtol=1e-6,
                               atol=1e-6 * scale)


def test_packet_injector_gates_on_delivery():
    """Only delivered packets are touched: lost ones pass bit-exact."""
    xp, mask = _packet_case()
    _, t = _packet_pair(xp, mask, 4, corrupt_rate=1.0, corrupt_scale=3.0,
                        bitflip_rate=1.0)
    lost = mask == 0.0
    np.testing.assert_array_equal(_bits(t[lost]), _bits(xp[lost]))
    assert (t[~lost] != xp[~lost]).all(-1).any()


def test_bitflip_changes_exactly_one_coordinate_per_hit_packet():
    xp, _ = _packet_case()
    _, t = _packet_pair(xp, np.ones(xp.shape[:2], np.float32), 8,
                        corrupt_rate=0.0, corrupt_scale=1.0,
                        bitflip_rate=1.0)
    np.testing.assert_array_equal((_bits(t) != _bits(xp)).sum(-1), 1)


def test_flip_bit_op_and_its_vmap_rule():
    """Every bit position, the sign bit included, against numpy's XOR;
    and the vmap rule against the loop, bitwise."""
    rng = np.random.default_rng(3)
    B, C, P, F = 2, 4, 8, 16
    x = rng.normal(size=(B, C, P, F)).astype(np.float32)
    coord = rng.integers(0, F, (B, C, P)).astype(np.int32)
    bit = (np.arange(B * C * P) % 32).reshape(B, C, P).astype(np.int32)
    hit = rng.random((B, C, P)) < 0.8
    args = [torch.tensor(a) for a in (x, coord, bit, hit)]
    got = torch.func.vmap(t_faults.flip_bit_op)(*args)
    loop = torch.stack([t_faults.flip_bit_op(*(a[i] for a in args))
                        for i in range(B)])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(loop.numpy()))
    want = x.copy().view(np.uint32)
    for idx in zip(*np.nonzero(hit)):
        want[idx + (coord[idx],)] ^= np.uint32(1) << np.uint32(bit[idx])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ---------------------------------------------------------------------------
# the round engine
# ---------------------------------------------------------------------------
_GRID6 = [
    (dict(), dict(trim_k=1)),
    (dict(corrupt_rate=0.1, corrupt_scale=5.0), dict(trim_k=1)),
    (dict(corrupt_rate=0.1, corrupt_scale=5.0),
     dict(screen=True, trim_k=1)),
    (dict(fail_rate=0.2),
     dict(screen=True, clip=True, clip_norm=5.0, trim_k=1)),
    (dict(flip_rate=0.2), dict(trim=True, trim_k=1)),
    (dict(corrupt_rate=0.1, bitflip_rate=0.05, fail_rate=0.1),
     dict(screen=True, clip=True, clip_norm=5.0, trim=True, trim_k=1)),
]


def _grid6(pkg, rounds=4):
    """The reference's one-program fault grid (tests/test_faults.py)."""
    return [_cfg(pkg, ef=True, rounds=rounds,
                 faults=dict(enabled=True, **fl), defense=df)
            for fl, df in _GRID6]


def test_fault_grid_matches_reference(inputs):
    """The 6-cell fault x defense grid, 4 rounds with EF, through both
    sweeps, the port starting from the reference's state."""
    je = JSweep.from_configs(_grid6("j"), inputs["jdata"], inputs["jnets"])
    j0 = je.init_states()
    t0 = engine_state_from_jax(j0, "cpu")
    jst, jlogs = je.run_block(j0, 0, 4)
    te = TSweep.from_configs(_grid6("t"), inputs["tdata"], inputs["tnets"],
                             device="cpu")
    tst, tlogs = te.run_block(t0, 0, 4)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_array_equal(tlogs["quarantine"], jlogs["quarantine"])
    assert tlogs["quarantine"][3].sum() > 0      # the NaN-failure cell
    np.testing.assert_array_equal(tst.net.channel.numpy(),
                                  np.asarray(jst.net.channel))
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    for s in range(len(_GRID6)):
        np.testing.assert_allclose(_vec(tst.params, s), _vec(jst.params, s),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{s}")
    np.testing.assert_allclose(tst.ef_mem.numpy(), np.asarray(jst.ef_mem),
                               rtol=1e-4, atol=1e-5)
    # the echo rows are single clients' local models, not cohort means:
    # local SGD from params 5e-6 apart crosses a ReLU kink in the
    # scale-5 corruption cell and parts by up to 4.3e-5 in a few floats
    np.testing.assert_allclose(tst.echo_mem.numpy(),
                               np.asarray(jst.echo_mem), rtol=1e-4,
                               atol=1e-4)


def test_fault_grid_cells_equal_single_runs(inputs):
    """Each cell of the port's sweep against the port's own single
    ``FederatedServer`` run: bitwise."""
    data, nets = inputs["tdata"], inputs["tnets"]
    cfgs = _grid6("t")
    te = TSweep.from_configs(cfgs, data, nets, device="cpu")
    st, logs = te.run()
    for i, c in enumerate(cfgs):
        srv = TServer(c, data, nets, device="cpu")
        s1, l1 = srv.engine.run_block(srv.engine.init_state(srv.params), 0,
                                      c.n_rounds)
        for name in ("ids", "quarantine", "loss"):
            np.testing.assert_array_equal(logs[name][i], l1[name])
        np.testing.assert_array_equal(_vec(st.params, i), _vec(s1.params))
        np.testing.assert_array_equal(st.ef_mem[i].numpy(),
                                      s1.ef_mem.numpy())
        np.testing.assert_array_equal(st.echo_mem[i].numpy(),
                                      s1.echo_mem.numpy())


def _run_port(cfg, data, nets):
    srv = TServer(cfg, data, nets, device="cpu")
    return srv.engine.run_block(srv.engine.init_state(srv.params), 0,
                                cfg.n_rounds)


@pytest.mark.parametrize("algo", ["fedavg", "qfedavg"])
def test_neutral_faults_equal_faults_off(inputs, algo):
    """``FaultConfig(enabled=True)`` at zero rates with the gates off is
    the faults-off trajectory: bitwise for fedavg, 1e-6 for qfedavg."""
    data, nets = inputs["tdata"], inputs["tnets"]
    off, off_logs = _run_port(_cfg(algo=algo, ef=True), data, nets)
    on, on_logs = _run_port(_cfg(algo=algo, ef=True,
                                 faults=dict(enabled=True)), data, nets)
    np.testing.assert_array_equal(on_logs["ids"], off_logs["ids"])
    np.testing.assert_array_equal(on_logs["quarantine"], 0.0)
    if algo == "qfedavg":
        np.testing.assert_allclose(_vec(on.params), _vec(off.params),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(on_logs["loss"], off_logs["loss"],
                                   rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(_vec(on.params), _vec(off.params))
        np.testing.assert_array_equal(on_logs["loss"], off_logs["loss"])
        np.testing.assert_array_equal(on.ef_mem.numpy(), off.ef_mem.numpy())


@pytest.mark.parametrize("debias", DEBIAS_MODES)
def test_neutral_lock_across_debias_modes(inputs, debias):
    data, nets = inputs["tdata"], inputs["tnets"]
    off, _ = _run_port(_cfg(debias=debias, rounds=2), data, nets)
    on, _ = _run_port(_cfg(debias=debias, rounds=2,
                           faults=dict(enabled=True)), data, nets)
    np.testing.assert_array_equal(_vec(on.params), _vec(off.params))


def _per_client_losses(params, data):
    dd = stage_on_device(data, "cpu")
    L = min(64, dd.train_x.shape[1])
    msk = (torch.arange(L)[None, :] < dd.counts[:, None]).float()
    with torch.no_grad():
        return torch.func.vmap(mlp_weighted_loss, in_dims=(None, 0, 0, 0))(
            params, dd.train_x[:, :L], dd.train_y[:, :L], msk).numpy()


def test_defense_recovers_faulted_run_where_undefended_diverges(inputs):
    """The reference's headline on the port: 10% per-packet Gaussian
    corruption + 10% NaN device failures on 30% bursty GE loss, 40
    rounds, three cells of one sweep. The undefended model goes
    non-finite; with screen + clip + trim the global mean and the
    bottom-quartile eval loss stay within 0.5 of the fault-free run."""
    faults = dict(enabled=True, corrupt_rate=0.1, corrupt_scale=0.5,
                  fail_rate=0.1)
    defense = dict(screen=True, clip=True, clip_norm=20.0, trim=True,
                   trim_k=2)

    def mk(fl, df):
        return _cfg(rounds=40, cpr=12, local_steps=4, batch_size=16, seed=1,
                    faults=fl, defense=df)

    cfgs = [mk(dict(enabled=True), dict(trim_k=2)),
            mk(faults, dict(trim_k=2)), mk(faults, defense)]
    data = inputs["tdata"]
    eng = TSweep.from_configs(cfgs, data, inputs["tnets"], device="cpu")
    st, logs = eng.run()
    l_clean, l_undef, l_def = (
        _per_client_losses({k: v[i] for k, v in st.params.items()}, data)
        for i in range(3))
    q = N_CLIENTS // 4

    def bq(losses):
        return np.sort(losses)[-q:].mean()

    assert not np.isfinite(l_undef).all()
    assert np.isfinite(l_def).all()
    assert l_def.mean() < l_clean.mean() + 0.5
    assert bq(l_def) < bq(l_clean) + 0.5
    assert logs["quarantine"][2].sum() > 0
    assert logs["quarantine"][0].sum() == 0
    assert_finite_tree({k: v[2] for k, v in st.params.items()},
                       name="defended")


# ---------------------------------------------------------------------------
# refusals, signatures, conversion, guards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("other", [
    dict(faults=dict()),                                  # enabled differs
    dict(faults=dict(enabled=True), defense=dict(trim_k=1))])   # trim_k
def test_grid_refuses_mixed_static_structure(inputs, other):
    base = _cfg(faults=dict(enabled=True))
    with pytest.raises(ValueError, match="static"):
        TSweep.from_configs([base, _cfg(**other)], inputs["tdata"],
                            inputs["tnets"], device="cpu")


def test_static_signature_normalises_fault_knobs():
    a = _cfg(faults=dict(enabled=True), defense=dict(trim_k=2))
    b = _cfg(faults=dict(enabled=True, corrupt_rate=0.3, fail_rate=0.1,
                         corrupt_scale=2.0, bitflip_rate=0.1,
                         flip_rate=0.2, echo_rate=0.4),
             defense=dict(screen=True, clip=True, clip_norm=3.0, trim=True,
                          trim_k=2))
    assert _static_key(a) == _static_key(b)
    assert _static_key(a) != _static_key(_cfg(faults=dict(enabled=True)))


@pytest.mark.parametrize("cfg_kw,match", [
    (dict(defense=dict(screen=True)), "faults.enabled"),
    (dict(defense=dict(trim_k=1)), "faults.enabled"),
    (dict(faults=dict(enabled=True), defense=dict(trim=True, trim_k=0)),
     "trim_k"),
    (dict(debias="per_coord_count", faults=dict(enabled=True),
          defense=dict(trim=True, trim_k=1)), "per_coord_count")])
def test_invalid_defense_configs_raise(inputs, cfg_kw, match):
    with pytest.raises(ValueError, match=match):
        TServer(_cfg(**cfg_kw), inputs["tdata"], inputs["tnets"],
                device="cpu")


def test_engine_state_from_jax_carries_the_fault_memories(inputs):
    je = JSweep.from_configs(_grid6("j", rounds=1), inputs["jdata"],
                             inputs["jnets"])
    jst, _ = je.run_block(je.init_states(), 0, 1)
    t = engine_state_from_jax(jst, "cpu")
    assert t.echo_mem.shape == (6, N_CLIENTS, 9098)
    np.testing.assert_array_equal(t.echo_mem.numpy(),
                                  np.asarray(jst.echo_mem))
    np.testing.assert_array_equal(t.ef_mem.numpy(), np.asarray(jst.ef_mem))
    np.testing.assert_array_equal(_vec(t.params, 2), _vec(jst.params, 2))
    assert t.rep_mem.shape == (6, 0)


def test_guards_flag_the_offending_leaf():
    tree = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, np.nan]),
                                      "n": torch.arange(3)}}
    assert not bool(all_finite_tree(tree))
    with pytest.raises(NonFiniteError, match=r"state/b/c.*1 NaN"):
        assert_finite_tree(tree, name="state")
    ok = {"a": torch.ones(3), "i": torch.arange(5)}
    assert bool(all_finite_tree(ok))
    assert_finite_tree(ok)
    assert bool(all_finite_tree({}))
    # NamedTuples name their fields: an engine state's leaf by its path
    st = TSweep.from_configs(
        [_cfg(faults=dict(enabled=True))],
        t_generate(np.random.default_rng(0), n_clients=4),
        TNets(np.linspace(1.0, 4.0, 4), np.full(4, 0.05)),
        device="cpu").init_states()
    assert bool(all_finite_tree(st))
    st.params["w1"][0, 1, 2] = np.inf
    with pytest.raises(NonFiniteError, match=r"st/params/w1.*0 NaN, 1 Inf"):
        assert_finite_tree(st, name="st")


def test_fault_fields_default_off():
    cfg = TConfig()
    assert cfg.faults == TFault() and not cfg.faults.enabled
    assert cfg.defense == TDefense()
    assert t_faults.clip_knob(TDefense()) == t_faults.CLIP_OFF
    assert t_faults.clip_knob(TDefense(clip=True, clip_norm=3.0)) == 3.0
    assert dataclasses.asdict(TFault()).keys() == \
        dataclasses.asdict(JFault()).keys()
    assert dataclasses.asdict(TDefense()).keys() == \
        dataclasses.asdict(JDefense()).keys()


# ---------------------------------------------------------------------------
# the trim past the card kernel's lists; the card's packet-width limit
# ---------------------------------------------------------------------------
def _trim17_cfg(pkg, rounds=2):
    """C = 40 of 50 clients, TRA at 2% loss (n > 2k in most packets),
    faults on, screen + clip 20 + trim 17: on the card the k passes over
    a column, past the kernel's 16-slot lists."""
    Cfg, Tra, Flt, Dfn = ((JConfig, JTRA, JFault, JDefense) if pkg == "j"
                          else (TConfig, TTRA, TFault, TDefense))
    return Cfg(algo="fedavg", n_rounds=rounds, clients_per_round=40,
               local_steps=2, batch_size=8, lr=0.1, eval_every=10 ** 6,
               seed=3, tra=Tra(enabled=True, loss_rate=0.02),
               faults=Flt(enabled=True, corrupt_rate=0.1, corrupt_scale=0.5,
                          fail_rate=0.1),
               defense=Dfn(screen=True, clip=True, clip_norm=20.0, trim=True,
                           trim_k=17))


def test_defended_trim17_engine_matches_reference_kernel(monkeypatch):
    """DefenseConfig(trim=True, trim_k=17) at C = 40: the port's engine
    (its plain version on the CPU) against the reference's with its
    Pallas robust kernel in interpret mode, 2 rounds from the
    reference's state: cohorts and quarantine counts bitwise, losses
    rtol 1e-5, params rtol 1e-4 / atol 1e-5 (the module's engine
    tolerances)."""
    monkeypatch.setenv("REPRO_ROBUST_IMPL", "kernel")
    n = 50
    speeds, loss = np.linspace(0.5, 20.0, n), np.full(n, 0.05)
    jdata = j_generate(np.random.default_rng(5), n_clients=n, alpha=0.5,
                       beta=0.5)
    tdata = t_generate(np.random.default_rng(5), n_clients=n, alpha=0.5,
                       beta=0.5)
    je = JSweep.from_configs([_trim17_cfg("j")], jdata, JNets(speeds, loss))
    j0 = je.init_states()
    t0 = engine_state_from_jax(j0, "cpu")
    jst, jlogs = je.run_block(j0, 0, 2)
    te = TSweep.from_configs([_trim17_cfg("t")], tdata, TNets(speeds, loss),
                             device="cpu")
    tst, tlogs = te.run_block(t0, 0, 2)
    np.testing.assert_array_equal(tlogs["ids"], jlogs["ids"])
    np.testing.assert_array_equal(tlogs["quarantine"], jlogs["quarantine"])
    assert tlogs["quarantine"].sum() > 0
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-5)
    np.testing.assert_allclose(_vec(tst.params, 0), _vec(jst.params, 0),
                               rtol=1e-4, atol=1e-5)


def _wide_cfg(F, faults):
    return dataclasses.replace(
        _cfg(rounds=1, faults=dict(enabled=faults)),
        tra=TTRA(enabled=True, loss_rate=0.3, packet_floats=F))


@pytest.mark.parametrize("F,faults,refused", [
    (2048, True, True), (1025, True, True), (1024, True, False),
    (2048, False, False)])
def test_card_refuses_wide_defended_packets_before_the_first_round(
        inputs, F, faults, refused):
    """The card's robust kernel screens a packet inside one CTA, so a run
    with faults and packets wider than 1,024 floats fails on a CUDA
    device with a ValueError as the engine is built, before any round
    (the device here is a stand-in: the check comes before anything is
    staged on it); the CPU runs it."""
    from repro_torch.core.engine import validate_device_config
    cfg = _wide_cfg(F, faults)
    if refused:
        with pytest.raises(ValueError, match=f"packet_floats={F}"):
            TServer(cfg, inputs["tdata"], inputs["tnets"], device="cuda")
        with pytest.raises(ValueError, match=f"packet_floats={F}"):
            TSweep.from_configs([cfg], inputs["tdata"], inputs["tnets"],
                                device="cuda")
    else:
        validate_device_config(cfg, "cuda")
    validate_device_config(cfg, "cpu")
    hist = TServer(cfg, inputs["tdata"], inputs["tnets"],
                   device="cpu").run()
    assert len(hist) == 1 and np.isfinite(hist[0].train_loss)
