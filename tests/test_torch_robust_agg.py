"""The port's defended uplink (``kernels/robust_agg``) against the JAX
reference.

On the CPU the port's ``robust_uplink_round`` runs its plain version
(``ref.robust_ref``); it is held against the reference's
``robust_uplink_round`` with its jnp oracle (``impl="ref"``) and with
its Pallas kernel in interpret mode (``impl="kernel"``), with NaN and
Inf planted in the uploads. Tolerances:
  * agg rtol 1e-6 / atol 1e-6 with equal NaN positions (the einsum and
    the trimmed mean's sums run in another order; the reference's own
    kernel-vs-oracle tolerance);
  * EF rows, quarantine counts and finite bits bitwise (element-wise
    selects and one rounding; a NaN compares by position);
  * s_clip, ssq and kept rtol 1e-6 (sums in another order).
The scenario-batched op under ``torch.func.vmap`` is held against the
loop of single calls bitwise. The unit semantics of the reference's
tests/test_faults.py are ported as tests of the port alone. The CUDA
kernel's own tests are in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.robust_agg import ops as j_ops
from repro_torch.core.tra import DEBIAS_MODES
from repro_torch.kernels import _build
from repro_torch.kernels.robust_agg import ops as t_ops
from repro_torch.kernels.robust_agg import robust_agg as t_ra
from repro_torch.kernels.robust_agg.ref import (TRIM_BIG,
                                                masked_trimmed_mean)
from repro_torch.kernels.uplink_fused import ops as uplink_ops
from repro_torch.netsim.faults import CLIP_OFF
from _torch_wide_cases import RecordingLib

C, P, F = 8, 6, 32
D_UP = P * F - 11                       # partial last packet
GATES = {"off": (0.0, CLIP_OFF, 0.0), "on": (1.0, 5.0, 1.0)}


def _case(seed, lead=()):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=lead + (C, D_UP)).astype(np.float32)
    pad = [(0, 0)] * (len(lead) + 1) + [(0, P * F - D_UP)]
    xp = np.pad(flat, pad).reshape(lead + (C, P, F))
    xp[..., 1, 2, 3] = np.nan
    xp[..., 3, 0, 0] = np.inf
    xp[..., 5, 4, 7] = -np.inf
    w = rng.random(lead + (C,)).astype(np.float32)
    w[..., C - 1] = 0.0                 # a weight-0 client: never valid
    return dict(
        xp=xp, ef=rng.normal(size=lead + (C, D_UP)).astype(np.float32),
        m=(rng.random(lead + (C, P)) < 0.7).astype(np.float32), w=w,
        suff=(rng.random(lead + (C,)) < 0.6).astype(np.float32),
        mult=(rng.random(lead + (C,)) + 0.5).astype(np.float32))


def _same_bits(a, b):
    """Bitwise equality, NaN compared by position (its payload is not
    part of the contract)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and \
        np.array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32))


def _cases():
    out = []
    for mode in DEBIAS_MODES:
        for k in ((0,) if mode == "per_coord_count" else (0, 2)):
            for gates in GATES:
                for ef in (False, True):
                    for impl in ("ref", "kernel"):
                        out.append((mode, k, gates, ef, impl))
    return out


@pytest.mark.parametrize("mode,trim_k,gates,use_ef,impl", _cases())
def test_robust_round_matches_reference(mode, trim_k, gates, use_ef, impl):
    c = _case(17)
    scr, cn, trg = GATES[gates]
    j = j_ops.robust_uplink_round(
        jnp.asarray(c["xp"]), jnp.asarray(c["m"]), jnp.asarray(c["w"]),
        mode=mode, d_up=D_UP, screen=jnp.float32(scr),
        clip_norm=jnp.float32(cn), trim_gate=jnp.float32(trg),
        trim_k=trim_k,
        ef_rows=jnp.asarray(c["ef"]) if use_ef else None,
        sufficient=jnp.asarray(c["suff"]), loss_rate=jnp.float32(0.3),
        mult=jnp.asarray(c["mult"]), want_ssq=True, impl=impl,
        interpret=True if impl == "kernel" else None)
    t = t_ops.robust_uplink_round(
        torch.tensor(c["xp"]), torch.tensor(c["m"]), torch.tensor(c["w"]),
        mode=mode, d_up=D_UP, screen=scr, clip_norm=cn, trim_gate=trg,
        trim_k=trim_k, ef_rows=torch.tensor(c["ef"]) if use_ef else None,
        sufficient=torch.tensor(c["suff"]), loss_rate=torch.tensor(0.3),
        mult=torch.tensor(c["mult"]), want_ssq=True)
    np.testing.assert_allclose(t.agg.numpy(), np.asarray(j.agg), rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    if gates == "off":       # the planted NaN reaches the aggregate
        assert np.isnan(t.agg.numpy()).any()
    else:
        assert np.isfinite(t.agg.numpy()).all()
    assert (t.ef_rows is None) == (not use_ef)
    if use_ef:
        assert _same_bits(t.ef_rows.numpy(), j.ef_rows)
    np.testing.assert_array_equal(t.qcnt.numpy(), np.asarray(j.qcnt))
    np.testing.assert_array_equal(t.pk_ok.numpy(), np.asarray(j.pk_ok))
    assert t.qcnt.sum() > 0
    for name in ("s_clip", "ssq", "kept"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       equal_nan=True, err_msg=name)


def test_batched_op_under_vmap_equals_loop():
    """The sweep's path: ``robust_uplink_round`` vmapped over S
    scenarios with per-scenario gates goes through the batched op and
    equals S single calls bitwise."""
    S = 3
    c = {k: torch.tensor(v) for k, v in _case(23, (S,)).items()}
    scr = torch.tensor([1.0, 0.0, 1.0])
    cn = torch.tensor([5.0, CLIP_OFF, CLIP_OFF])
    trg = torch.tensor([0.0, 0.0, 1.0])

    def one(xp, m, w, ef, suff, mult, s, cl, tg):
        r = t_ops.robust_uplink_round(
            xp, m, w, mode="group_rate", d_up=D_UP, screen=s, clip_norm=cl,
            trim_gate=tg, trim_k=2, ef_rows=ef, sufficient=suff,
            loss_rate=torch.tensor(0.3), mult=mult, want_ssq=True)
        return r.agg, r.ef_rows, r.ssq, r.qcnt, r.s_clip

    args = (c["xp"], c["m"], c["w"], c["ef"], c["suff"], c["mult"], scr,
            cn, trg)
    batched = torch.func.vmap(one)(*args)
    for i in range(S):
        single = one(*(a[i] for a in args))
        for b, s in zip(batched, single):
            assert _same_bits(b[i].numpy(), s.numpy())
    # the gates did differ per scenario
    assert np.isnan(batched[0][1].numpy()).any()
    assert np.isfinite(batched[0][0].numpy()).all()


# ---------------------------------------------------------------------------
# unit semantics (the reference's tests/test_faults.py, on the port)
# ---------------------------------------------------------------------------
def _rand_uplink(rng, C_=6, P_=5, F_=8, d_up=37):
    xp = rng.normal(size=(C_, P_, F_)).astype(np.float32)
    m = (rng.random((C_, P_)) < 0.7).astype(np.float32)
    w = rng.integers(10, 100, C_).astype(np.float32)
    suff = (rng.random(C_) < 0.8).astype(np.float32)
    return xp, m, w, suff, d_up


@pytest.mark.parametrize("mode", DEBIAS_MODES)
def test_screen_quarantines_exactly_as_if_lost(mode):
    """A non-finite packet under the screen gives bit for bit the
    aggregate of the same uplink with that packet lost, in every mode."""
    rng = np.random.default_rng(3)
    xp, m, w, suff, d_up = _rand_uplink(rng)
    bad = [(0, 1), (2, 4), (5, 0)]
    xq = xp.copy()
    m_lost = m.copy()
    for c, p in bad:
        xq[c, p, 3] = np.nan if (c + p) % 2 else np.inf
        m_lost[c, p] = 0.0
    kw = dict(mode=mode, d_up=d_up, sufficient=torch.tensor(suff),
              loss_rate=torch.tensor(0.3), want_ssq=True)
    rob = t_ops.robust_uplink_round(
        torch.tensor(xq), torch.tensor(m), torch.tensor(w), screen=1.0,
        clip_norm=CLIP_OFF, trim_gate=0.0, **kw)
    kept = None
    if mode == "per_client_rate":
        P_, F_ = xp.shape[1], xp.shape[2]
        pcnt = np.full(P_, F_, np.float32)
        pcnt[-1] = F_ - (P_ * F_ - d_up)
        kept = torch.tensor((m_lost @ pcnt) / d_up)
    agg, _, ssq = uplink_ops.uplink_round(
        torch.tensor(xp), torch.tensor(m_lost), torch.tensor(w), kept=kept,
        **kw)
    assert torch.equal(rob.agg, agg)
    assert torch.equal(rob.ssq, ssq)
    want_q = np.zeros(xp.shape[0], np.float32)
    for c, p in bad:
        want_q[c] += m[c, p]
    np.testing.assert_array_equal(rob.qcnt.numpy(), want_q)


def test_clip_matches_closed_form():
    """s_clip = clip / ||x||_masked over the threshold, exactly 1.0
    under it; the clipped aggregate equals that of pre-scaled uploads."""
    rng = np.random.default_rng(5)
    xp, m, w, suff, d_up = _rand_uplink(rng)
    xp[0] *= 40.0
    masked = xp * np.repeat(m, xp.shape[2], axis=1).reshape(xp.shape)
    cn = float(1.2 * np.sqrt((masked[1:] ** 2).sum(axis=(1, 2))).max())
    kw = dict(mode="none", d_up=d_up, sufficient=torch.tensor(suff),
              loss_rate=torch.tensor(0.3))
    rob = t_ops.robust_uplink_round(
        torch.tensor(xp), torch.tensor(m), torch.tensor(w), screen=0.0,
        clip_norm=cn, trim_gate=0.0, want_ssq=True, **kw)
    norms = np.sqrt(rob.ssq.numpy())
    s = rob.s_clip.numpy()
    over = norms > cn
    assert over[0] and not over.all()
    np.testing.assert_allclose(s[over], cn / norms[over], rtol=1e-6)
    np.testing.assert_array_equal(s[~over], 1.0)
    base = t_ops.robust_uplink_round(
        torch.tensor(xp * s[:, None, None]), torch.tensor(m),
        torch.tensor(w), screen=0.0, clip_norm=CLIP_OFF, trim_gate=0.0,
        **kw)
    np.testing.assert_allclose(rob.agg.numpy(), base.agg.numpy(),
                               rtol=1e-5, atol=1e-6)


def _numpy_trimmed_mean(y, valid, k):
    C_, P_, F_ = y.shape
    want = np.zeros((P_, F_), np.float32)
    for p in range(P_):
        rows = [c for c in range(C_) if valid[c, p] > 0]
        for f in range(F_):
            vals = np.sort(np.array([y[c, p, f] for c in rows]))
            if len(vals) > 2 * k:
                want[p, f] = vals[k:-k].mean()
            elif len(vals):
                want[p, f] = vals.mean()
    return want


def test_trimmed_mean_matches_numpy_oracle():
    rng = np.random.default_rng(11)
    C_, P_, F_, k = 7, 3, 4, 2
    y = rng.normal(size=(C_, P_, F_)).astype(np.float32) * 10
    valid = (rng.random((C_, P_)) < 0.6).astype(np.float32)
    got = masked_trimmed_mean(torch.tensor(y), torch.tensor(valid), k)
    np.testing.assert_allclose(got.numpy(),
                               _numpy_trimmed_mean(y, valid, k),
                               rtol=1e-5, atol=1e-5)


def _kernel_trim(y, valid, k):
    """The CUDA kernel's trimmed mean (csrc/robust_agg.cu), transcribed
    in numpy float32: one pass over the clients in index order inserts
    each client's lo and hi value into sorted lists of K = k rounded up
    to a power of two slots (+-inf when empty, a NaN moves nothing); pass
    i's value is slot i, capped at +-TRIM_BIG from the second pass on (a
    valid NaN makes total NaN, so pass 0 needs no case for it)."""
    big = np.float32(TRIM_BIG)
    K = next(s for s in t_ra.TRIM_SLOTS if s >= k)
    C_, P_, F_ = y.shape
    out = np.zeros((P_, F_), np.float32)
    for p in range(P_):
        for f in range(F_):
            n = total = np.float32(0)
            lo, hi = [np.float32(np.inf)] * K, [np.float32(-np.inf)] * K
            for c in range(C_):
                v, yc = valid[c, p], y[c, p, f]
                n += v
                total += yc * v
                lv, hv = (yc, yc) if v > 0 else (big, -big)
                for i in range(K - 1, 0, -1):
                    lo[i] = lo[i - 1] if lv < lo[i - 1] else \
                        (lv if lv < lo[i] else lo[i])
                    hi[i] = hi[i - 1] if hv > hi[i - 1] else \
                        (hv if hv > hi[i] else hi[i])
                lo[0] = lv if lv < lo[0] else lo[0]
                hi[0] = hv if hv > hi[0] else hi[0]
            bot = top = np.float32(0)
            for i in range(k):
                bot += lo[0] if i == 0 else (lo[i] if lo[i] < big else big)
                top += hi[0] if i == 0 else \
                    (hi[i] if hi[i] > -big else -big)
            two_k = np.float32(2 * k)
            cnt = max(n - two_k, np.float32(1))
            out[p, f] = (total - top - bot) / cnt if n > two_k \
                else total / max(n, np.float32(1))
    return out


def _successor_extraction(y, valid, k):
    """The reference's k passes as a successor extraction: pass i takes
    the (value, index) successor of pass i-1 (the reference retires
    first occurrences), capped at +-TRIM_BIG from the second pass on."""
    big = np.float32(TRIM_BIG)
    C_, P_, F_ = y.shape
    out = np.zeros((P_, F_), np.float32)
    for p in range(P_):
        for f in range(F_):
            n = total = np.float32(0)
            for c in range(C_):
                n += valid[c, p]
                total += y[c, p, f] * valid[c, p]
            bot = top = np.float32(0)
            lo, hi = (-np.inf, -1), (np.inf, -1)
            for i in range(k):
                best = None
                for c in range(C_):
                    v = y[c, p, f] if valid[c, p] > 0 else big
                    if (v > lo[0] or (v == lo[0] and c > lo[1])) and \
                            (best is None or v < best[0]):
                        best = (v, c)
                bv = big if best is None else best[0]
                lo = lo if best is None else best
                bot += big if i > 0 and not bv < big else bv
                best = None
                for c in range(C_):
                    v = y[c, p, f] if valid[c, p] > 0 else -big
                    if (v < hi[0] or (v == hi[0] and c > hi[1])) and \
                            (best is None or v > best[0]):
                        best = (v, c)
                bv = -big if best is None else best[0]
                hi = hi if best is None else best
                top += -big if i > 0 and not bv > -big else bv
            two_k = np.float32(2 * k)
            cnt = max(n - two_k, np.float32(1))
            out[p, f] = (total - top - bot) / cnt if n > two_k \
                else total / max(n, np.float32(1))
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_kernel_extraction_order_matches_sort(k):
    """The kernel's trimmed mean against the sorting plain version, on
    ties, values past TRIM_BIG and infinities: the same estimator (the
    kernel runs only on the card; this holds its algorithm here); and
    bitwise the reference's k-pass extraction."""
    rng = np.random.default_rng(29 + k)
    C_, P_, F_ = 9, 8, 16
    y = rng.integers(-3, 4, size=(C_, P_, F_)).astype(np.float32)  # ties
    y[:, 1] = rng.normal(size=(C_, F_)) * 1e38                     # huge
    y[2, 2, :4] = np.inf
    y[5, 2, 2:6] = -np.inf
    y[:, 3] = 3.3e38                          # all past TRIM_BIG
    valid = (rng.random((C_, P_)) < 0.75).astype(np.float32)
    valid[:, 3] = 1.0
    valid[:, 4] = 0.0                         # nothing valid
    with np.errstate(over="ignore", invalid="ignore"):   # inf - inf
        got = _kernel_trim(y, valid, k)
        assert _same_bits(got, _successor_extraction(y, valid, k))
    want = masked_trimmed_mean(torch.tensor(y), torch.tensor(valid),
                               k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("nan", [False, True])
def test_kernel_trim_equals_the_k_pass_extraction(k, nan):
    """The kernel's one-pass sorted lists bitwise the reference's k-pass
    extraction (NaN by position) on ties, values past TRIM_BIG,
    infinities, n <= 2k and, with ``nan``, NaN in valid slots (an
    undefended trim), for k at and between the kernel's list lengths."""
    rng = np.random.default_rng(31 + k)
    C_, P_, F_ = 19, 8, 16
    y = rng.integers(-3, 4, size=(C_, P_, F_)).astype(np.float32)
    y[:, 1] = rng.normal(size=(C_, F_)) * 1e38
    y[2, 2, :4] = np.inf
    y[5, 2, 2:6] = -np.inf
    y[:, 3] = 3.3e38
    valid = (rng.random((C_, P_)) < 0.75).astype(np.float32)
    valid[:, 3] = 1.0
    valid[:, 4] = 0.0
    valid[:3, 5], valid[3:, 5] = 1.0, 0.0     # n = 3 <= 2k for k >= 2
    if nan:
        y[4, 6, :8] = np.nan
        valid[4, 6] = 1.0
        y[:, 7, 0] = np.nan                   # every valid slot NaN
        valid[:, 7] = 1.0
    with np.errstate(over="ignore", invalid="ignore"):
        assert _same_bits(_kernel_trim(y, valid, k),
                          _successor_extraction(y, valid, k))


@pytest.mark.parametrize("C_,k", [(40, 17), (40, 24), (14, 6)])
@pytest.mark.parametrize("nan", [False, True])
def test_kernel_trim_paths_equal_the_reference_extraction(C_, k, nan):
    """Past the kernel's lists (k = 17, 24 at C = 40: the kernel's own k
    passes over a column, transcribed as ``_successor_extraction``) and
    on them where n - 2k is about 1 (C = 14, k = 6: the lists, as
    ``_kernel_trim``): bitwise the reference kernel's k-pass
    ``_trimmed_extract`` itself, NaN by position. The uploads are small
    integers (ties, and sums exact in any order, so the reference's
    own sums cannot part from the kernel's index order), with columns
    past TRIM_BIG and infinities planted, n around 2k."""
    from repro.kernels.robust_agg.robust_agg import _trimmed_extract
    rng = np.random.default_rng(C_ + k)
    P_, F_ = 8, 16
    y = rng.integers(-3, 4, size=(C_, P_, F_)).astype(np.float32)
    y[:, 1] = 3.3e38                          # all past TRIM_BIG
    y[2, 2, :4] = np.inf
    y[5, 2, 2:6] = -np.inf
    valid = (rng.random((C_, P_)) < 0.9).astype(np.float32)
    valid[:, 1] = 1.0
    valid[:, 3] = 0.0                         # nothing valid
    valid[:2 * k - 1, 4], valid[2 * k - 1:, 4] = 1.0, 0.0   # n = 2k - 1
    valid[:2 * k + 1, 5], valid[2 * k + 1:, 5] = 1.0, 0.0   # n = 2k + 1
    if nan:
        y[4, 6, :8] = np.nan
        valid[4, 6] = 1.0
    with np.errstate(over="ignore", invalid="ignore"):
        got = _successor_extraction(y, valid, k)
        want = np.asarray(_trimmed_extract(jnp.asarray(y),
                                           jnp.asarray(valid[..., None]), k))
        assert _same_bits(got, want)
        if k <= t_ra.TRIM_SLOTS[-1]:
            assert _same_bits(_kernel_trim(y, valid, k), want)


def test_trim_defeats_sign_flip_byzantine():
    rng = np.random.default_rng(9)
    C_, P_, F_ = 9, 4, 16
    sig = rng.normal(size=(P_, F_)).astype(np.float32)
    xp = sig[None] + rng.normal(size=(C_, P_, F_)).astype(np.float32) * .05
    xp[:2] = -3.0 * sig[None]            # two byzantine clients
    m = np.ones((C_, P_), np.float32)
    w = np.ones(C_, np.float32)

    def agg(trg):
        return t_ops.robust_uplink_round(
            torch.tensor(xp), torch.tensor(m), torch.tensor(w), mode="none",
            d_up=P_ * F_, screen=0.0, clip_norm=CLIP_OFF, trim_gate=trg,
            trim_k=2).agg.numpy()

    truth = sig.reshape(-1)
    assert np.linalg.norm(agg(1.0) - truth) \
        < 0.2 * np.linalg.norm(agg(0.0) - truth)


def test_trim_validity_excludes_zero_weight_clients():
    rng = np.random.default_rng(13)
    C_, P_, F_ = 5, 2, 8
    xp = rng.normal(size=(C_, P_, F_)).astype(np.float32)
    xp[4] = 1e3                          # huge, but weight 0
    m = np.ones((C_, P_), np.float32)
    w = np.array([1, 1, 1, 1, 0], np.float32)

    def agg(n):
        return t_ops.robust_uplink_round(
            torch.tensor(xp[:n]), torch.tensor(m[:n]), torch.tensor(w[:n]),
            mode="none", d_up=P_ * F_, screen=0.0, clip_norm=CLIP_OFF,
            trim_gate=1.0, trim_k=1).agg.numpy()

    np.testing.assert_allclose(agg(5), agg(4), rtol=1e-6)


def test_kernel_binding_refuses_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor never falls back to
    the plain version inside them, and no launch is counted."""
    c = {k: torch.tensor(v) for k, v in _case(1).items()}
    gate = torch.tensor(1.0)
    before = (t_ra.LAUNCHES, t_ra.BATCHED_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        t_ra.robust_agg_call(c["xp"], c["m"], c["w"], c["w"].sum(), gate,
                             gate, per_coord=False)
    with pytest.raises(ValueError, match="CUDA"):
        t_ra.robust_agg_batched_call(
            c["xp"][None], c["m"][None], c["w"][None], c["w"].sum()[None],
            gate[None], gate[None], per_coord=False)
    assert (t_ra.LAUNCHES, t_ra.BATCHED_LAUNCHES) == before
    assert "robust_agg" in _build.KERNELS
    assert (_build.CSRC / "robust_agg.cu").exists()


class _OnCard:
    """Stands in for a tensor on the card: the refusal reads only
    ``is_cuda``, so a CPU tensor in any other slot is what it refuses."""
    is_cuda = True


_OPERANDS = ("x", "m", "q", "w_or_den", "screen", "trim_gate", "ef", "g",
             "w_pos")


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", _OPERANDS)
def test_kernel_entries_refuse_a_cpu_operand_first(batched, name):
    """A CPU tensor in any operand raises the CUDA refusal, named, before
    a counter moves and before the library is built or loaded: the rest
    of the operands stand in for tensors on the card, and the CPU one is
    also of the wrong dtype and shape, so no later check can raise
    first."""
    ops = {k: _OnCard() for k in _OPERANDS}
    ops[name] = torch.zeros(3, dtype=torch.float64)
    entry = t_ra.robust_agg_batched_call if batched else t_ra.robust_agg_call
    before = (t_ra.LAUNCHES, t_ra.BATCHED_LAUNCHES, t_ra._lib.cache_info())
    with pytest.raises(ValueError, match=f"CUDA tensors only, and {name} "
                                         f"lies on cpu"):
        entry(*(ops[k] for k in _OPERANDS[:6]), ef=ops["ef"], g=ops["g"],
              w_pos=ops["w_pos"], trim_k=2, per_coord=False)
    assert (t_ra.LAUNCHES, t_ra.BATCHED_LAUNCHES,
            t_ra._lib.cache_info()) == before


def _pl(chunk, slots, smem, threads=256, column=False):
    return t_ra.Plan(chunk, slots, smem, threads, column)


PASSES = t_ra.PASSES


@pytest.mark.parametrize("S,C_,P_,F_,trim_k,ef,want", [
    (1, 12, 36, 256, 2, False, _pl(12, 2, 12 * 256 * 4)),   # cell
    (9, 12, 36, 256, 2, False, _pl(12, 2, 12 * 256 * 4)),   # grid
    (1, 12, 36, 256, 0, False, _pl(12, 0, 12 * 256 * 4)),
    (1, 1, 36, 256, 1, True, _pl(1, 1, 2 * 256 * 4)),
    (1, 16, 36, 256, 3, False, _pl(16, 4, 16 * 256 * 4)),
    (1, 17, 36, 256, 5, False, _pl(16, 8, 16 * 256 * 4)),
    (1, 17, 36, 256, 0, True, _pl(16, 0, 2 * 16 * 256 * 4)),
    (1, 64, 1024, 256, 2, True, _pl(16, 2, 2 * 16 * 256 * 4)),
    (8, 64, 1024, 256, 0, False, _pl(16, 0, 16 * 256 * 4)),
    (1, 64, 4, 1024, 16, True, _pl(16, 16, 2 * 16 * 1024 * 4, 1024)),
    (65535, 1, 1, 32, 0, False, _pl(1, 0, 32 * 4, 32)),
    # trim_k > 16: the k passes over a (C, F + 1) column in shared memory
    # beside the chunk's rows, or in device memory where it does not fit
    (1, 40, 36, 256, 17, False,
     _pl(16, PASSES, 16 * 256 * 4 + 40 * 257 * 4)),
    (1, 40, 36, 256, 24, True,
     _pl(16, PASSES, 2 * 16 * 256 * 4 + 40 * 257 * 4)),
    (2, 40, 36, 256, 20, False,
     _pl(16, PASSES, 16 * 256 * 4 + 40 * 257 * 4)),
    (1, 50, 8, 1024, 17, True, _pl(16, PASSES, 2 * 16 * 1024 * 4, 1024,
                                   True)),
    (1, 300, 36, 256, 17, False, _pl(16, PASSES, 16 * 256 * 4, 256, True)),
    # C = 14, k = 6 stays on the lists
    (1, 14, 36, 256, 6, False, _pl(14, 8, 14 * 256 * 4)),
    # packet widths off a multiple of 32: F rounded up to whole warps,
    # a chunk row a float a thread
    (1, 12, 36, 1, 2, False, _pl(12, 2, 12 * 32 * 4, 32)),
    (1, 12, 36, 100, 2, True, _pl(12, 2, 2 * 12 * 128 * 4, 128)),
    (1, 12, 36, 255, 0, False, _pl(12, 0, 12 * 256 * 4, 256)),
    (1, 40, 36, 100, 17, False,
     _pl(16, PASSES, 16 * 128 * 4 + 40 * 101 * 4, 128)),
    (1, 12, 36, 1024, 2, False, _pl(12, 2, 12 * 1024 * 4, 1024))])
def test_launch_plan_at_the_paths_shapes(S, C_, P_, F_, trim_k, ef, want):
    assert t_ra.plan(S, C_, P_, F_, trim_k, ef) == want
    # the most a CTA may opt into, beside the kernel's 896 static bytes
    assert want.smem + 896 <= 232448


@pytest.mark.parametrize("S,C_,P_,F_,trim_k,msg", [
    (1, 12, 36, 0, 2, "F in \\[1, 1024\\]"),
    (1, 12, 36, 1025, 2, "F in \\[1, 1024\\]"),
    (1, 12, 36, 1056, 0, "F in \\[1, 1024\\]"),
    (1, 0, 36, 256, 2, "S, C, P > 0"),
    (1, 12, 0, 256, 2, "S, C, P > 0"),
    (0, 12, 36, 256, 2, "S, C, P > 0"),
    (1, 12, 36, 256, -1, "trim_k must be >= 0"),
    (1, 40, 36, 256, -17, "trim_k must be >= 0")])
def test_launch_plan_refuses_what_the_kernel_cannot_take(S, C_, P_, F_,
                                                         trim_k, msg):
    for ef in (False, True):
        with pytest.raises(ValueError, match=msg):
            t_ra.plan(S, C_, P_, F_, trim_k, ef)


def test_launch_plan_constants_follow_the_kernel_source():
    """CHUNK and TRIM_SLOTS restate the kernel's largest chunk and its
    trim instances, and the kernel's static shared memory (two buffers of
    32 warp words and 5 scalars a client) is what the plan's bound above
    leaves beside the chunk's rows: the planner holds only while they
    agree."""
    src = (_build.CSRC / "robust_agg.cu").read_text()
    assert f"constexpr int kChunk = {t_ra.CHUNK};" in src
    assert "constexpr int kMaxWarps = 32;" in src
    assert src.count("[2][kChunk]") == 5 and "s_bad[2][kMaxWarps]" in src
    assert 2 * (32 + 5 * t_ra.CHUNK) * 4 == 896
    for k in (0, *t_ra.TRIM_SLOTS):
        assert f"kernel = instance<{k}>(tail);" in src
    assert f"constexpr int kPass = {t_ra.PASSES};" in src
    assert "kernel = instance<kPass>(tail);" in src
    assert t_ra.SMEM_LIMIT == 232448 - 896


def test_binding_check_names_the_operand():
    """The per-operand fallback of the one-pass check: device (naming
    CUDA), dtype, shape, contiguity, in that order."""
    card = torch.device("cuda", 0)
    t = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="m must be a CUDA tensor on "
                                         "cuda:0, not on cpu"):
        t_ra._check("m", t, (2, 3), card)
    here = t.device
    with pytest.raises(TypeError, match="q must be float32"):
        t_ra._check("q", t.double(), (2, 3), here)
    with pytest.raises(ValueError, match=r"g must have shape \(3, 2\)"):
        t_ra._check("g", t, (3, 2), here)
    with pytest.raises(ValueError, match="ef must be contiguous"):
        t_ra._check("ef", t.t(), (3, 2), here)
    t_ra._check("x", t, (2, 3), here)



@pytest.mark.parametrize("S,chunks", [(65536, [65535, 1]),
                                      (131073, [65535, 65535, 3])])
@pytest.mark.parametrize("trim_k", [0, 2])
def test_batched_binding_launches_past_65535_scenarios_in_chunks(
        monkeypatch, S, chunks, trim_k):
    """Scenarios lie on grid.y: the binding launches a chunk of at most
    MAX_SCENARIOS at a time, every operand and output offset to the
    chunk's first scenario, and counts each launch."""
    assert t_ra.MAX_SCENARIOS == 65535
    lib = RecordingLib("robust_agg_launch")
    monkeypatch.setattr(t_ra, "_lib", lambda: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    C, P, F = 3, 1, 2
    x = torch.zeros((S, C, P, F))
    ef = torch.zeros_like(x)
    m, q, g, w_pos = (torch.ones((S, C, P)), torch.ones((S, C)),
                      torch.ones((S, C)), torch.ones((S, C)))
    den, screen, trim_gate = torch.ones(S), torch.ones(S), torch.ones(S)
    before = t_ra.BATCHED_LAUNCHES
    agg, ef_out = t_ra._launch((S,), x, m, q, den, screen, trim_gate, ef, g,
                               w_pos, trim_k, False)
    assert t_ra.BATCHED_LAUNCHES - before == len(chunks)
    assert [c[12] for c in lib.calls] == chunks
    trim = trim_k > 0
    s0 = 0
    for call, n in zip(lib.calls, chunks):
        ptrs = [x, ef, m, q, g if trim else None, w_pos if trim else None,
                den, screen, trim_gate, agg, ef_out, None]
        assert list(call[:12]) == [
            None if t is None else t.data_ptr()
            + s0 * t.stride(0) * t.element_size() for t in ptrs]
        s0 += n
