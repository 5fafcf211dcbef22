"""The port's protocol layer against the JAX reference: the packet-mask,
TRA aggregation and q-FedAvg reweighting ops, the packet functions, the
host-loop round and the q-FedAvg server step.

On the CPU each op runs its plain version; it is held against the
reference's Pallas kernel in interpret mode (where the reference runs
it: P a multiple of 8) and against the reference's public entry points.
Inputs come from numpy seeds. Tolerances:
- packet_mask, apply_packet_mask, sample_packet_mask, lossy_upload:
  bitwise (one multiply per element; 0/1 masks from the same threefry
  draws). In bf16 a NaN is compared by position only: PyTorch's bf16
  rounding writes every NaN as 0x7FC0, XLA's keeps the sign bit.
- tra_agg: rtol 1e-5 / atol 1e-6 (the einsum sums over clients in
  another order), as the reference holds its own kernel; the mode
  pre-scaling bitwise.
- qfed_reweight: delta bitwise given the same fq (one multiply), ssq and
  h rtol 1e-5; through the flat entry delta rtol 1e-6, because
  ``torch.pow`` and XLA's ``pow`` may differ by 1 ulp in fq.
- tra.aggregate against the engine's uplink step: rtol 2e-5 / atol 1e-6,
  the reference's own lock (tests/test_sweep.py).
- the host-loop round, 3 rounds from the reference's weights: cohorts
  and packet masks bitwise, kept fractions bitwise, params rtol 1e-5 /
  atol 1e-6.
- the q-FedAvg step: params rtol 1e-5 / atol 1e-6.
The CUDA kernels' own tests are in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch
from jax.flatten_util import ravel_pytree

from repro.core import tra as j_tra
from repro.core.client_updates import LOCAL_FNS as J_LOCAL
from repro.core.client_updates import qfedavg_local as j_qfedavg_local
from repro.core.mlp import mlp_init as j_mlp_init
from repro.core.server import FLConfig as JConfig
from repro.data.synthetic import generate_synthetic as j_generate
from repro.data.synthetic import sample_batches as j_sample_batches
from repro.kernels.packet_mask import ops as j_pm_ops
from repro.kernels.packet_mask.packet_mask import packet_mask_call
from repro.kernels.qfed_reweight import ops as j_qr_ops
from repro.kernels.qfed_reweight.qfed_reweight import qfed_reweight_call
from repro.kernels.tra_agg import ops as j_ta_ops
from repro.kernels.tra_agg.tra_agg import tra_agg_call
from repro.network import packets as j_pk
from repro.network.trace import sample_networks as j_sample_networks
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import protocol
from repro_torch.core.client_updates import fedavg_local
from repro_torch.core.mlp import mlp_init as t_mlp_init
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.kernels.common import RATE_EPS
from repro_torch.kernels.packet_mask import ops as t_pm_ops
from repro_torch.kernels.packet_mask import packet_mask as t_pm
from repro_torch.kernels.packet_mask.packet_mask import \
    packet_mask_call as t_pm_call
from repro_torch.kernels.qfed_reweight import ops as t_qr_ops
from repro_torch.kernels.qfed_reweight import qfed_reweight as t_qr
from repro_torch.kernels.qfed_reweight.qfed_reweight import \
    qfed_reweight_call as t_qr_call
from repro_torch.kernels.tra_agg import ops as t_ta_ops
from repro_torch.kernels.tra_agg import tra_agg as t_ta
from repro_torch.kernels.tra_agg.tra_agg import tra_agg_call as t_ta_call
from repro_torch.kernels.uplink_fused import ops as uplink_ops
from repro_torch.network import packets as t_pk
from repro_torch.network.trace import sample_networks as t_sample_networks
from _torch_wide_cases import RecordingLib


def _bits(a):
    """The raw bits of a float32 or bfloat16 numpy or torch array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _planted(shape, seed):
    """Normals with NaN, +-Inf, -0.0 and negatives planted in the first
    packet rows, so delivered and lost rows both hold them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -np.inf, -0.0]
    x[1, :4] = [np.nan, np.inf, -np.inf, -2.5]
    m = (rng.random(shape[0]) > 0.3).astype(np.float32)
    m[0], m[1] = 0.0, 1.0
    return x, m


# ---------------------------------------------------------------------------
# packet_mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P,F", [(8, 256), (64, 256), (128, 256), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packet_mask_matches_reference_kernel(P, F, dtype):
    x, m = _planted((P, F), P * F)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(packet_mask_call(jx, jnp.asarray(m), block_p=8,
                                      interpret=True))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = t_pm_ops.packet_mask_op(tx, torch.from_numpy(m))
    assert out.dtype == tx.dtype
    got = out.float().numpy()
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(ref.astype(np.float32)))
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(out), _bits(ref))
    else:
        np.testing.assert_array_equal(_bits(out)[~nan], _bits(ref)[~nan])
    # a lost -2.5 and a lost -0.0 keep their sign: a multiply, not a select
    assert np.signbit(got[0, 3]) and got[0, 3] == 0.0


@pytest.mark.parametrize("D", [100, 256, 5000, 65536])
def test_apply_packet_mask_matches_reference(D):
    rng = np.random.default_rng(D)
    vec = rng.normal(size=D).astype(np.float32)
    mask = (rng.random(-(-D // 256)) > 0.5).astype(np.float32)
    ref = np.asarray(j_pm_ops.apply_packet_mask(jnp.asarray(vec),
                                                jnp.asarray(mask), 256))
    out = t_pk.apply_packet_mask(torch.from_numpy(vec),
                                 torch.from_numpy(mask))
    assert out.shape == (D,)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_packet_mask_vmap_fold_equals_single_calls():
    """The cohort's vmap folds the batch into the packet rows."""
    rng = np.random.default_rng(5)
    vec = torch.from_numpy(rng.normal(size=(4, 1000)).astype(np.float32))
    mask = torch.from_numpy((rng.random((4, 4)) > 0.4).astype(np.float32))
    folded = torch.func.vmap(t_pk.apply_packet_mask)(vec, mask)
    for i in range(4):
        assert torch.equal(folded[i],
                           t_pk.apply_packet_mask(vec[i], mask[i]))


# ---------------------------------------------------------------------------
# packet functions
# ---------------------------------------------------------------------------
def test_flatten_update_leaf_order_and_roundtrip():
    rng = np.random.default_rng(0)
    tree = {k: rng.normal(size=s).astype(np.float32) for k, s in
            (("w2", (4, 3)), ("b1", (5,)), ("w1", (2, 5)), ("b2", (3,)))}
    jvec, _ = ravel_pytree({k: jnp.asarray(v) for k, v in tree.items()})
    tvec, unravel = t_pk.flatten_update(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    back = unravel(tvec * 2)
    assert list(back) == sorted(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k].numpy(), 2 * v)


@pytest.mark.parametrize("seed,n,rate", [(0, 36, 0.1), (3, 200, 0.3),
                                         (11, 1, 0.5), (7, 4096, 0.9)])
def test_sample_packet_mask_bitwise(seed, n, rate):
    ref = np.asarray(j_pk.sample_packet_mask(jax.random.PRNGKey(seed), n,
                                             rate))
    out = t_pk.sample_packet_mask(prng.PRNGKey(seed), n, rate)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("D,rate", [(9098, 0.1), (256 * 200, 0.3),
                                    (100, 0.5)])
def test_lossy_upload_bitwise(D, rate):
    vec = np.random.default_rng(D).normal(size=D).astype(np.float32)
    jm, jp, jk = j_pk.lossy_upload(jax.random.PRNGKey(D), jnp.asarray(vec),
                                   rate)
    tm, tp, tk = t_pk.lossy_upload(prng.PRNGKey(D), torch.from_numpy(vec),
                                   rate)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(tm), _bits(np.asarray(jm)))
    assert _bits(tk.reshape(1)) == _bits(np.asarray(jk).reshape(1))


def test_lossy_upload_vmap_equals_single_uploads():
    keys = prng.split(prng.PRNGKey(9), 10)
    vec = torch.from_numpy(np.random.default_rng(9).normal(
        size=(10, 9098)).astype(np.float32))
    masked, pm, kept = torch.func.vmap(
        lambda k, v: t_pk.lossy_upload(k, v, 0.3))(keys, vec)
    for i in range(10):
        m1, p1, k1 = t_pk.lossy_upload(keys[i], vec[i], 0.3)
        assert torch.equal(masked[i], m1) and torch.equal(pm[i], p1)
        assert torch.equal(kept[i], k1)


# ---------------------------------------------------------------------------
# tra_agg
# ---------------------------------------------------------------------------
def _agg_case(C, P, F, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, P, F)).astype(np.float32),
            (rng.random((C, P)) > 0.25).astype(np.float32),
            (np.abs(rng.normal(size=C)) + 0.1).astype(np.float32))


@pytest.mark.parametrize("C,P,F", [(2, 8, 256), (5, 16, 256),
                                   (16, 64, 256), (3, 8, 128)])
def test_tra_agg_matches_reference_kernel(C, P, F):
    x, m, w = _agg_case(C, P, F, C * P)
    ref = tra_agg_call(jnp.asarray(x), jnp.asarray(m), jnp.asarray(w),
                       block_p=8, interpret=True)
    out = t_ta_ops.tra_agg_op(*map(torch.from_numpy, (x, m, w)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _mode_case(C=10, D=9098, seed=36):
    """The host loop's width: D = 9,098, P = 36 (the reference runs its
    plain version there, as P % 8 != 0)."""
    rng = np.random.default_rng(seed)
    P = -(-D // 256)
    m = (rng.random((C, P)) > 0.2).astype(np.float32)
    coord = np.repeat(m, 256, axis=1)[:, :D]
    return dict(x=(rng.normal(size=(C, D)).astype(np.float32) * coord),
                m=m, w=(rng.random(C) + 0.1).astype(np.float32),
                kept=coord.mean(1).astype(np.float32),
                rate=np.full(C, 0.2, np.float32),
                suff=(rng.random(C) > 0.5).astype(np.float32))


@pytest.mark.parametrize("mode", t_ta_ops.DEBIAS_MODES)
def test_tra_aggregate_every_mode_at_p36(mode):
    c = _mode_case()
    ref = j_ta_ops.tra_aggregate(
        jnp.asarray(c["x"]), jnp.asarray(c["m"]), jnp.asarray(c["w"]),
        mode=mode, kept_frac=jnp.asarray(c["kept"]),
        nominal_rate=jnp.asarray(c["rate"]),
        sufficient=jnp.asarray(c["suff"]))
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    out = t_ta_ops.tra_aggregate(t["x"], t["m"], t["w"], mode=mode,
                                 kept_frac=t["kept"],
                                 nominal_rate=t["rate"],
                                 sufficient=t["suff"])
    assert out.shape == (9098,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["per_client_rate", "group_rate"])
def test_mode_prescale_is_bitwise_the_reference(mode):
    """The pre-scaled tensor the kernel gets: the reference's reciprocal
    then multiply (group_rate) or division (per_client_rate)."""
    c = _mode_case()
    x = jnp.asarray(c["x"])
    if mode == "group_rate":
        scale = jnp.where(jnp.asarray(c["suff"]).astype(bool), 1.0,
                          1.0 / jnp.maximum(1.0 - jnp.asarray(c["rate"]),
                                            RATE_EPS))
        ref = np.asarray(x * scale[:, None])
    else:
        ref = np.asarray(x / jnp.maximum(jnp.asarray(c["kept"]),
                                         RATE_EPS)[:, None])
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    got, m = t_ta_ops.debias_inputs(
        t["x"][:, None, :], t["m"][:, :1], mode=mode, kept_frac=t["kept"],
        nominal_rate=t["rate"], sufficient=t["suff"])
    np.testing.assert_array_equal(_bits(got[:, 0]), _bits(ref))
    assert torch.equal(m, torch.ones_like(m))


def test_tra_agg_vmap_is_the_batched_op():
    """Under vmap the op runs its scenario-batched twin once; each
    scenario's aggregate is its single call's."""
    S, C, P, F = 3, 4, 12, 32
    x, m, w = _agg_case(S * C, P, F, 1)
    x, m = x.reshape(S, C, P, F), m.reshape(S, C, P)
    w = np.stack([w[:C]] * S)
    tx, tm, tw = map(torch.from_numpy, (x, m, w))
    out = torch.func.vmap(t_ta_ops.tra_agg_op)(tx, tm, tw)
    for s in range(S):
        np.testing.assert_allclose(
            out[s].numpy(), t_ta_ops.tra_agg_op(tx[s], tm[s], tw[s]).numpy(),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", t_ta_ops.DEBIAS_MODES)
def test_tra_aggregate_locked_to_the_engine_uplink(mode):
    """tests/test_sweep.py:180-214, ported: the engine's fused uplink
    step and the packed TRA entry implement the same estimators."""
    rng = np.random.default_rng(42)
    C, P, F = 6, 16, 32
    d_up = P * F - 11                         # partial last packet
    flat = torch.from_numpy(rng.normal(size=(C, d_up)).astype(np.float32))
    pkt_mask = torch.from_numpy((rng.random((C, P)) > 0.3).astype(
        np.float32))
    weights = torch.from_numpy(rng.random(C).astype(np.float32) + 0.1)
    suff = torch.from_numpy((rng.random(C) > 0.5).astype(np.float32))
    xp = torch.nn.functional.pad(flat, (0, 11)).reshape(C, P, F)
    pcnt = torch.full((P,), float(F))
    pcnt[-1] = F - 11
    kept = (pkt_mask @ pcnt) / d_up
    fused, _, _ = uplink_ops.uplink_round(
        xp, pkt_mask, weights, mode=mode, d_up=d_up, kept=kept,
        sufficient=suff, loss_rate=torch.tensor(0.3))
    coord = t_pk.coordinate_mask(pkt_mask.reshape(-1), C * P * F, F
                                 ).reshape(C, P * F)[:, :d_up]
    xk = torch.nn.functional.pad(flat * coord, (0, 11)).reshape(C, P, F)
    packed = t_ta_ops.tra_aggregate_packed(
        xk, pkt_mask, weights, mode=mode, kept_frac=kept,
        nominal_rate=torch.full((C,), 0.3), sufficient=suff
    ).reshape(-1)[:d_up]
    np.testing.assert_allclose(fused.numpy(), packed.numpy(), rtol=2e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# qfed_reweight
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,P", [(2, 8), (7, 16), (16, 64)])
def test_qfed_reweight_matches_reference_kernel(C, P):
    rng = np.random.default_rng(C * P)
    dw = rng.normal(size=(C, P, 256)).astype(np.float32)
    fq = (np.abs(rng.normal(size=C)) + 0.01).astype(np.float32)
    d1, s1 = qfed_reweight_call(jnp.asarray(dw), jnp.asarray(fq), block_p=8,
                                interpret=True)
    d2, s2 = t_qr_ops.qfed_reweight_op(torch.from_numpy(dw),
                                       torch.from_numpy(fq))
    np.testing.assert_array_equal(_bits(d2), _bits(np.asarray(d1)))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), rtol=1e-5)


@pytest.mark.parametrize("q", [0.0, 1.0, 2.0])
def test_qfed_reweight_flat_entry_and_h(q):
    """The flat entry against the reference's, and h against the direct
    formula of tests/test_kernels.py."""
    C, D, L = 4, 1000, 10.0
    rng = np.random.default_rng(2)
    dw = rng.normal(size=(C, D)).astype(np.float32)
    losses = np.array([0.5, 1.0, 2.0, 3.0], np.float32)
    jd, jh = j_qr_ops.qfed_reweight(jnp.asarray(dw), jnp.asarray(losses),
                                    q, L)
    td, th = t_qr_ops.qfed_reweight(torch.from_numpy(dw),
                                    torch.from_numpy(losses), q, L)
    assert td.shape == (C, D)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5)
    ssq = (dw.astype(np.float64) ** 2).sum(1)
    l64 = losses.astype(np.float64) + 1e-10
    np.testing.assert_allclose(th.numpy(),
                               q * l64 ** (q - 1) * ssq + L * l64 ** q,
                               rtol=1e-5)


def test_qfed_reweight_vmap_folds_into_clients():
    rng = np.random.default_rng(4)
    dw = torch.from_numpy(rng.normal(size=(3, 5, 4, 64)).astype(np.float32))
    fq = torch.from_numpy(rng.random((3, 5)).astype(np.float32) + 0.1)
    delta, ssq = torch.func.vmap(t_qr_ops.qfed_reweight_op)(dw, fq)
    for s in range(3):
        d1, s1 = t_qr_ops.qfed_reweight_op(dw[s], fq[s])
        assert torch.equal(delta[s], d1)
        np.testing.assert_allclose(ssq[s].numpy(), s1.numpy(), rtol=1e-6)


@pytest.mark.parametrize("cpu", ["dw", "fq", "both"])
def test_qfed_reweight_refuses_a_cpu_operand_first(cpu):
    """A CPU tensor in either operand raises the CUDA refusal, named,
    before the counter moves and before the library is built or loaded,
    whatever else is wrong with it (here a float64 of the wrong shape)."""
    bad = torch.zeros((2, 3, 5), dtype=torch.float64)
    dw = _OnCard() if cpu == "fq" else bad
    fq = _OnCard() if cpu == "dw" else bad
    before = (t_qr.LAUNCHES, t_qr._lib.cache_info())
    name = "fq" if cpu == "fq" else "dw"
    with pytest.raises(ValueError, match=f"CUDA tensors only, and {name} "
                                         f"lies on cpu"):
        t_qr.qfed_reweight_call(dw, fq)
    assert (t_qr.LAUNCHES, t_qr._lib.cache_info()) == before


def test_qfed_reweight_check_names_the_operand():
    """The per-operand fallback of the one-pass check: device (naming
    CUDA), dtype, shape, contiguity, in that order; the binding keeps
    its own check, apart from the uplink kernel's binding."""
    card = torch.device("cuda", 0)
    dw = torch.zeros((4, 3, 8))
    with pytest.raises(ValueError, match="dw must be a CUDA tensor on "
                                         "cuda:0, not on cpu"):
        t_qr._check("dw", dw, (4, 3, 8), card)
    with pytest.raises(TypeError, match="fq must be float32"):
        t_qr._check("fq", torch.zeros(4, dtype=torch.float64), (4,),
                    dw.device)
    with pytest.raises(ValueError, match=r"fq must have shape \(4,\)"):
        t_qr._check("fq", torch.zeros(3), (4,), dw.device)
    with pytest.raises(ValueError, match="dw must be contiguous"):
        t_qr._check("dw", dw.transpose(0, 2), (8, 3, 4), dw.device)
    assert t_qr._check.__module__ == t_qr.__name__


def _qr_plan(vec, cluster, threads, C):
    return t_qr.Plan(vec, cluster, threads, C * cluster)


@pytest.mark.parametrize("C,P,F,aligned,want", [
    (10, 36, 256, True, _qr_plan(True, 1, 576, 10)),     # the host loop's
    (16, 1024, 256, True, _qr_plan(True, 8, 512, 16)),   # the reference's
    (30, 36, 256, True, _qr_plan(True, 1, 576, 30)),     # vmap of S = 3
    (10, 36, 256, False, _qr_plan(False, 2, 512, 10)),   # a misaligned view
    (10, 36, 255, True, _qr_plan(True, 1, 576, 10)),     # D % 4 == 0
    (10, 35, 255, True, _qr_plan(False, 2, 512, 10)),    # D % 4 != 0
    (10, 64, 256, True, _qr_plan(True, 1, 1024, 10)),    # one step, 1,024
    (10, 65, 256, True, _qr_plan(True, 1, 512, 10)),     # past one step
    (10, 129, 256, True, _qr_plan(True, 2, 512, 10)),    # past SPAN units
    (4, 3, 2500, True, _qr_plan(True, 1, 480, 4)),
    (3, 5, 33, True, _qr_plan(False, 1, 64, 3)),
    (1, 1, 256, True, _qr_plan(True, 1, 32, 1)),
    (65536, 1, 1, True, _qr_plan(False, 1, 32, 65536)),  # past grid.y
    (5, 0, 256, True, _qr_plan(True, 1, 32, 5))])        # empty rows
def test_qfed_reweight_plan(C, P, F, aligned, want):
    """16-byte units only where D % 4 == 0 and the rows are aligned; a
    row of at most ONE_STEP units in one CTA, in one step of UNROLL
    units a thread; a longer row over K CTAs of at most MAX_THREADS, K
    doubling while a CTA would take more than SPAN units, up to 8;
    clients on grid.x, so C past 65,535 takes C * K CTAs."""
    assert t_qr.plan(C, P * F, aligned) == want


@pytest.mark.parametrize("D", [9216, 262144, 9180, 1])
def test_qfed_reweight_plan_follows_the_row_alone(D):
    """K, the CTA size and the unit width do not depend on C, so that a
    vmapped call (C -> S * C) sums each row in its single call's order;
    a grid past 2^31 - 1 CTAs is refused."""
    plans = {t_qr.plan(C, D, True)[:3] for C in (1, 10, 270, 2 ** 20)}
    assert len(plans) == 1
    with pytest.raises(ValueError, match="more CTAs than a grid has"):
        t_qr.plan(2 ** 31, D, True)


# ---------------------------------------------------------------------------
# the host-loop round and the q-FedAvg step
# ---------------------------------------------------------------------------
SEED, N_CLIENTS, CPR = 7, 100, 10


@pytest.fixture(scope="module")
def loop_data():
    """benchmarks/engine_bench.py's dataset, then the clients' networks
    from the same generator, in both packages."""
    jr, tr = np.random.default_rng(SEED), np.random.default_rng(SEED)
    jd = j_generate(jr, n_clients=N_CLIENTS, alpha=1.0, beta=1.0)
    td = t_generate(tr, n_clients=N_CLIENTS, alpha=1.0, beta=1.0)
    jn, tn = j_sample_networks(jr, N_CLIENTS), t_sample_networks(tr,
                                                                 N_CLIENTS)
    np.testing.assert_array_equal(jn.upload_mbps, tn.upload_mbps)
    return jd, td, j_tra.sufficiency_report(jn)


def _reference_round_fn(cfg):
    """engine_bench.py:78-87's jitted round, from repro's public
    functions, also returning the mask and kept fractions."""
    hyper = cfg.hyper()
    local = J_LOCAL["fedavg"]

    @jax.jit
    def round_fn(params, X, Y, weights, suff, key):
        C = X.shape[0]
        uploads, aux = jax.vmap(lambda p, x, y: local(p, x, y, hyper),
                                in_axes=(None, 0, 0))(params, X, Y)
        flat = j_tra.flatten_clients(uploads, C)
        masked, pkt_mask, kept = j_tra.simulate_uploads(
            key, flat, suff, cfg.tra.loss_rate, cfg.tra.packet_floats)
        agg = j_tra.aggregate(masked, pkt_mask, weights, suff, kept,
                              cfg.tra)
        return (j_tra.unflatten_like(agg, params), aux["loss0"].mean(),
                pkt_mask, kept)

    return round_fn


@pytest.mark.parametrize("steps,bs", [(1, 8), (10, 32)])
@pytest.mark.parametrize("sufficiency", ["all", "report"])
def test_host_loop_rounds_match_reference(loop_data, steps, bs,
                                          sufficiency):
    jd, td, report = loop_data
    suff = np.ones(N_CLIENTS, np.float32) if sufficiency == "all" \
        else report
    kw = dict(algo="fedavg", n_rounds=3, clients_per_round=CPR,
              local_steps=steps, batch_size=bs, eval_every=10 ** 6,
              seed=SEED)
    jcfg = JConfig(**kw, tra=j_tra.TRAConfig(enabled=True, loss_rate=0.1))
    tcfg = TConfig(**kw, tra=TTRA(enabled=True, loss_rate=0.1))
    round_fn = _reference_round_fn(jcfg)
    jp = j_mlp_init(jax.random.PRNGKey(SEED))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")

    rng = np.random.default_rng(SEED)
    lost = 0.0
    for inp in protocol.round_inputs(tcfg, td, suff):
        ids = rng.choice(N_CLIENTS, CPR, replace=False)
        X, Y = j_sample_batches(rng, jd, ids, steps, bs)
        w = jd.samples_per_client[ids].astype(np.float32)
        np.testing.assert_array_equal(inp.ids, ids)
        np.testing.assert_array_equal(inp.X, X)
        key = jax.random.PRNGKey(hash((SEED, inp.t)) % (2 ** 31))
        jp, jloss, jmask, jkept = round_fn(
            jp, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w / w.sum()),
            jnp.asarray(suff[ids]), key)
        tp, rec = protocol.step(tp, inp, tcfg, "cpu")
        np.testing.assert_array_equal(rec.pkt_mask.numpy(),
                                      np.asarray(jmask))
        np.testing.assert_array_equal(rec.kept.numpy(), np.asarray(jkept))
        np.testing.assert_allclose(rec.loss, float(jloss), rtol=1e-5)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        lost += float((1.0 - rec.pkt_mask).sum())
    # nothing is lost when every client is sufficient; the report's
    # insufficient clients lose packets, so the debias acts
    assert (lost == 0.0) == (sufficiency == "all")


def test_run_host_loop_is_its_steps(loop_data):
    """run_host_loop is round_inputs + step from mlp_init's weights."""
    _, td, report = loop_data
    cfg = TConfig(algo="fedavg", n_rounds=2, clients_per_round=CPR,
                  local_steps=1, batch_size=8, seed=SEED,
                  tra=TTRA(enabled=True, loss_rate=0.1))
    params, recs = protocol.run_host_loop(cfg, td, report, device="cpu")
    p = t_mlp_init(prng.PRNGKey(SEED))
    for inp in protocol.round_inputs(cfg, td, report):
        p, rec = protocol.step(p, inp, cfg, "cpu")
        assert torch.equal(rec.pkt_mask, recs[inp.t].pkt_mask)
    for k in p:
        assert torch.equal(p[k], params[k])
    with pytest.raises(ValueError):
        protocol.run_host_loop(TConfig(algo="afl"), td, report,
                               device="cpu")


@pytest.mark.parametrize("q", [0.0, 1.0])
def test_qfedavg_step_matches_reference_composition(q):
    """tests/test_algorithms.py:56-66's server step, in both packages."""
    data = j_generate(np.random.default_rng(0), n_clients=20, alpha=0.5,
                      beta=0.5)
    params = j_mlp_init(jax.random.PRNGKey(0))
    X, Y = j_sample_batches(np.random.default_rng(1), data, np.arange(6),
                            8, 16)
    hyper = {"lr": 0.1, "lipschitz": 10.0}
    dws, aux = jax.vmap(lambda x, y: j_qfedavg_local(
        params, x, y, hyper))(jnp.asarray(X), jnp.asarray(Y))
    delta, h = j_qr_ops.qfed_reweight(j_tra.flatten_clients(dws, 6),
                                      aux["loss0"], q, 10.0)
    w_vec, unravel = ravel_pytree(params)
    expect = unravel(w_vec - delta.sum(0) / h.sum())

    cfg = TConfig(algo="qfedavg", lr=0.1, lipschitz=10.0, q=q)
    tp = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                         "cpu")
    new, loss = protocol.qfed_round(tp, torch.from_numpy(X),
                                    torch.from_numpy(Y), cfg)
    np.testing.assert_allclose(float(loss), float(aux["loss0"].mean()),
                               rtol=1e-5)
    for k in expect:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(expect[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if q == 0.0:
        # q = 0 with full delivery is plain FedAvg's mean of the models
        models, _ = torch.func.vmap(lambda x, y: fedavg_local(
            tp, x, y, cfg.hyper()))(torch.from_numpy(X), torch.from_numpy(Y))
        for k in new:
            np.testing.assert_allclose(new[k].numpy(),
                                       models[k].mean(0).numpy(),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["tra_agg", "qfed_reweight", "packet_mask"])
def test_kernel_calls_raise_on_cpu_tensors(name):
    """The bindings launch or raise: no silent plain fallback."""
    x = torch.zeros((2, 4, 8))
    call = {"tra_agg": lambda: t_ta_call(x, torch.ones(2, 4), torch.ones(2)),
            "qfed_reweight": lambda: t_qr_call(x, torch.ones(2)),
            "packet_mask": lambda: t_pm_call(x[0], torch.ones(4))}[name]
    with pytest.raises(ValueError, match="CUDA"):
        call()


class _OnCard:
    """Stands in for a tensor on the card: the refusal reads only
    ``is_cuda``."""
    is_cuda = True


@pytest.mark.parametrize("cpu", ["x", "mask", "both"])
def test_packet_mask_refuses_a_cpu_operand_first(cpu):
    """A CPU tensor in either operand raises the CUDA refusal, named,
    before the counter moves and before the library is built or loaded,
    whatever else is wrong with it (here a float64 of the wrong shape)."""
    bad = torch.zeros((2, 3, 5), dtype=torch.float64)
    x = _OnCard() if cpu == "mask" else bad
    mask = _OnCard() if cpu == "x" else bad
    before = (t_pm.LAUNCHES, t_pm._lib.cache_info())
    name = "mask" if cpu == "mask" else "x"
    with pytest.raises(ValueError, match=f"CUDA tensors only, and {name} "
                                         f"lies on cpu"):
        t_pm.packet_mask_call(x, mask)
    assert (t_pm.LAUNCHES, t_pm._lib.cache_info()) == before


def test_packet_mask_check_names_the_operand():
    """The per-operand fallback of the one-pass check: device (naming
    CUDA), dtype, shape, contiguity, in that order. The binding keeps
    its own check, apart from the other kernels' bindings."""
    card = torch.device("cuda", 0)
    dt = (torch.float32, torch.bfloat16)
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="x must be a CUDA tensor on "
                                         "cuda:0, not on cpu"):
        t_pm._check("x", x, (4, 8), dt, card)
    with pytest.raises(TypeError, match="x must be torch.float32 or "
                                        "torch.bfloat16, not torch.float16"):
        t_pm._check("x", x.half(), (4, 8), dt, x.device)
    with pytest.raises(ValueError, match=r"mask must have shape \(4,\)"):
        t_pm._check("mask", torch.zeros(3), (4,), dt[:1], x.device)
    with pytest.raises(ValueError, match="x must be contiguous"):
        t_pm._check("x", x.t(), (8, 4), dt, x.device)
    t_pm._check("x", x.bfloat16(), (4, 8), dt, x.device)
    assert t_pm._check.__module__ == t_pm.__name__


@pytest.mark.parametrize("C,P,F", [(5, 16, 255), (3, 8, 33)])
def test_tra_agg_odd_packet_width_matches_reference_kernel(C, P, F):
    """Packet widths off a multiple of 32: the port's op against the
    reference's interpret-mode Pallas kernel, at the tolerance of
    ``test_tra_agg_matches_reference_kernel``."""
    x, m, w = _agg_case(C, P, F, C * P + F)
    ref = tra_agg_call(jnp.asarray(x), jnp.asarray(m), jnp.asarray(w),
                       block_p=8, interpret=True)
    out = t_ta_ops.tra_agg_op(*map(torch.from_numpy, (x, m, w)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", ["x", "mask", "w"])
def test_tra_agg_refuses_a_cpu_operand_first(batched, name):
    """A CPU tensor in any operand of either entry raises the CUDA
    refusal, named, before the counter moves and before the library is
    built or loaded, whatever else is wrong with it."""
    ops = {k: _OnCard() for k in ("x", "mask", "w")}
    ops[name] = torch.zeros(3, dtype=torch.float64)
    entry = t_ta.tra_agg_batched_call if batched else t_ta.tra_agg_call
    before = (t_ta.LAUNCHES, t_ta._lib.cache_info())
    with pytest.raises(ValueError, match=f"CUDA tensors only, and {name} "
                                         f"lies on cpu"):
        entry(ops["x"], ops["mask"], ops["w"])
    assert (t_ta.LAUNCHES, t_ta._lib.cache_info()) == before


def test_tra_agg_check_names_the_operand():
    """The per-operand fallback of the one-pass check: device (naming
    CUDA), dtype, shape, contiguity, in that order; the binding keeps
    its own check, apart from the uplink kernel's binding."""
    card = torch.device("cuda", 0)
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="x must be a CUDA tensor on "
                                         "cuda:0, not on cpu"):
        t_ta._check("x", x, (4, 8), card)
    with pytest.raises(TypeError, match="w must be float32"):
        t_ta._check("w", x.double(), (4, 8), x.device)
    with pytest.raises(ValueError, match=r"mask must have shape \(4,\)"):
        t_ta._check("mask", x, (4,), x.device)
    with pytest.raises(ValueError, match="x must be contiguous"):
        t_ta._check("x", x.t(), (8, 4), x.device)
    assert t_ta._check.__module__ == t_ta.__name__


def _ta_plan(rows, tiles, threads, C=10):
    chunk = min(t_ta.CHUNK, C, t_ta.SMEM_BUDGET // (16 * threads))
    return t_ta.Plan(rows, tiles, threads, chunk, chunk * 16 * threads)


@pytest.mark.parametrize("S,C,P,F,want", [
    (1, 10, 36, 256, _ta_plan(1, 1, 64)),        # the host loop's call
    (1, 16, 1024, 256, _ta_plan(1, 1, 64, 16)),  # the reference's bench
    (4, 10, 36, 256, _ta_plan(1, 1, 64)),
    (1, 3, 8, 128, _ta_plan(2, 1, 64, 3)),
    (1, 10, 36, 255, _ta_plan(1, 1, 64)),
    (1, 10, 36, 1, _ta_plan(32, 1, 32)),
    (1, 10, 5, 1, _ta_plan(5, 1, 32)),
    (1, 10, 36, 100, _ta_plan(2, 1, 64)),
    (1, 40, 36, 1024, _ta_plan(1, 1, 256, 40)),
    (1, 10, 36, 20000, _ta_plan(1, 20, 256))])
def test_tra_agg_plan_covers_any_packet_width(S, C, P, F, want):
    """Rows under 256 floats share a CTA (at most MAX_ROWS), rows past
    TILE floats are cut into tiles; each thread over 4 floats, whole
    warps, at most TILE / 4 threads."""
    pl = t_ta.plan(S, C, P, F)
    assert pl == want
    TILE = t_ta.TILE
    span = pl.rows * F if pl.tiles == 1 else TILE
    assert pl.threads % 32 == 0 and 4 * pl.threads >= span
    assert pl.threads <= TILE // 4 and pl.rows <= t_ta.MAX_ROWS
    assert pl.tiles * TILE >= F
    assert 1 <= pl.chunk <= t_ta.CHUNK and pl.smem <= t_ta.SMEM_BUDGET


def test_tra_agg_plan_constants_follow_the_kernel_source():
    from repro_torch.kernels import _build
    src = (_build.CSRC / "tra_agg.cu").read_text()
    assert f"constexpr int kMaxRows = {t_ta.MAX_ROWS};" in src
    assert f"constexpr int kTile = {t_ta.TILE};" in src
    assert f"constexpr int kChunk = {t_ta.CHUNK};" in src
    # the static mask weights (2 x kChunk x kMaxRows floats) beside the
    # dynamic budget stay within the 48 KB without an opt-in
    assert t_ta.SMEM_BUDGET + 2 * t_ta.CHUNK * t_ta.MAX_ROWS * 4 <= 48 * 1024
    # any scenario count: the binding launches past 65,535 in chunks,
    # each with the plan of the whole call
    assert t_ta.plan(65536, 10, 36, 256) == t_ta.plan(1, 10, 36, 256)



@pytest.mark.parametrize("S,chunks", [(65536, [65535, 1]),
                                      (131073, [65535, 65535, 3])])
def test_tra_agg_batched_binding_launches_past_65535_scenarios_in_chunks(
        monkeypatch, S, chunks):
    """Scenarios lie on grid.y: the binding launches a chunk of at most
    MAX_SCENARIOS at a time, operands and output offset to the chunk's
    first scenario, and counts each launch."""
    assert t_ta.MAX_SCENARIOS == 65535
    lib = RecordingLib("tra_agg_launch")
    monkeypatch.setattr(t_ta, "_lib", lambda: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    C, P, F = 3, 2, 4
    x, m, w = (torch.zeros((S, C, P, F)), torch.ones((S, C, P)),
               torch.ones((S, C)))
    before = t_ta.LAUNCHES
    out = t_ta._launch((S,), x, m, w, 1e-8)
    assert t_ta.LAUNCHES - before == len(chunks)
    assert [c[4] for c in lib.calls] == chunks
    s0 = 0
    for call, n in zip(lib.calls, chunks):
        assert list(call[:4]) == [t.data_ptr() + s0 * t.stride(0) * 4
                                  for t in (x, m, w, out)]
        s0 += n
