"""Device-resident telemetry for the round engine.

The paper's claims (loss tolerance below a critical packet-loss
fraction, selection bias under thresholding, bottom-quartile fairness)
are statements about per-round, per-client signals. The engine runs
blocks of rounds on the device and the sweep batches whole grids, so
those signals are accumulated on the device and leave it with the
block's logs, never a round at a time. This module is that layer:

  * ``TelemetryConfig(level=...)``, a static engine knob:

      - ``"off"``     builds the whole subsystem out: the step runs not
                      one op more than without telemetry.
      - ``"scalars"`` adds per-round scalars and compact per-cohort
                      aggregates (delivered-packet fraction, realized
                      loss rate, participation share per bandwidth
                      quartile, staleness histogram, quarantine
                      fraction, EF and update norms, debias-scale mean,
                      the recovery and controller signals) to the logs
                      under ``"tele/..."`` keys.
      - ``"full"``    also carries cumulative per-client aggregates
                      (participation counts, arrival mass, staleness and
                      quarantined-packet sums) through the rounds as
                      ``TelemetryState``, the last field of
                      ``EngineState``; checkpoints round-trip it like
                      any other carry.

    The level changes the step's structure, so it is part of the static
    signature: it must agree across a sweep.

  * ``records_from_logs`` demuxes flushed block logs (single-engine
    ``(k, ...)`` or sweep-stacked ``(S, k, ...)``) into typed
    ``RoundRecord``s (``utils/events.py``) for the JSONL event stream
    that ``tools/flstat.py`` renders.

  * ``REGISTRY`` / ``TimedProgram``: the host-side program-timing layer
    around the engine's and the sweep's step caches. Every cache lookup
    logs the step key's fingerprint (hit or insert), every dispatch its
    host time, and a fingerprint shared by two different keys raises.

Telemetry reads signals the round already computes (masks, arrival
weights, quarantine counts, EF rows); it never changes the training
math at any level.

The reference computes these keys inside its jitted step, where XLA
takes the mean of a 0/1 mask as the exact count times the float32
reciprocal of its size, fused with a following ``1 -`` into one
rounding, and fuses the quantile's interpolation into one multiply-add;
the port computes them so (``xla_mean``, ``one_minus_mean01``,
``bandwidth_quartiles``) and holds them bitwise.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils.events import RoundRecord, fingerprint_of

logger = logging.getLogger("repro_torch.telemetry")

LEVELS = ("off", "scalars", "full")
N_QUARTILES = 4

# TelemetryConfig fields a scenario may vary without changing the step's
# structure: none, the level and the histogram's shape are structure.
SWEEP_VARYING_TELE_FIELDS = ()


@dataclasses.dataclass
class TelemetryConfig:
    """Static telemetry knobs (module doc). ``stale_bins`` sizes the
    per-round lateness histogram (the last bin absorbs everything later,
    never-arriving uploads pinned at MAX_LATENESS included)."""
    level: str = "off"
    stale_bins: int = 8

    def __post_init__(self):
        assert self.level in LEVELS, self.level
        assert self.stale_bins >= 2, self.stale_bins


class TelemetryState(NamedTuple):
    """Cumulative per-client aggregates, a carry inside ``EngineState``.
    Every field is (N,) f32 at level="full" and (0,) otherwise."""
    part_count: torch.Tensor    # cohort memberships to date
    arrival_mass: torch.Tensor  # sum of effective arrival weights
    stale_sum: torch.Tensor     # sum of observed deadline lateness
    quar_pkts: torch.Tensor     # quarantined packets attributed


def init_telemetry_state(tcfg: TelemetryConfig, n_clients: int,
                         device=None) -> TelemetryState:
    """Four distinct zero buffers, (N,) at level="full", else (0,)."""
    n = n_clients if tcfg.level == "full" else 0
    return TelemetryState(*(torch.zeros((n,), device=device)
                            for _ in range(4)))


def bandwidth_quartiles(logbw) -> torch.Tensor:
    """(N,) int32 quartile id per client (0 = slowest 25%) from the
    static log-bandwidth draw, on ``logbw``'s device; ties break toward
    the lower quartile. Computed on the host, once per scenario, as the
    reference's ``jnp.quantile`` comes out of XLA: the cut positions
    q·(N-1) and their weights in float32, the interpolation
    ``low·w_low + high·w_high`` one fused multiply-add (the exact
    product ``low·w_low`` plus the rounded ``high·w_high``, rounded
    once), then ``logbw > cut`` summed over the three cuts. The ids are
    the reference's bit for bit, ties included, where an unfused
    interpolation may put a cut an ulp below a tied value."""
    x = np.asarray(torch.as_tensor(logbw).detach().cpu(), np.float32)
    a = np.sort(x)
    n1 = np.float32(x.shape[0] - 1)
    pos = np.array([0.25, 0.5, 0.75], np.float32) * n1
    lo = np.floor(pos)
    w_hi = (pos - lo).astype(np.float32)
    w_lo = np.float32(1.0) - w_hi
    lo_v = a[lo.astype(np.int64)]
    hi_v = a[np.ceil(pos).astype(np.int64)]
    cut = (lo_v.astype(np.float64) * w_lo.astype(np.float64)
           + (hi_v * w_hi).astype(np.float64)).astype(np.float32)
    if np.isnan(x).any():
        cut[:] = np.nan
    qid = (x[:, None] > cut[None, :]).sum(axis=1).astype(np.int32)
    return torch.from_numpy(qid).to(torch.as_tensor(logbw).device)


def xla_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over all elements as XLA compiles ``jnp.mean``: the sum
    times the float32 reciprocal of the size. For a 0/1 mask or integer
    counts the sum is exact, and so the mean is the reference's bit for
    bit."""
    return x.sum() * float(np.float32(1.0) / np.float32(x.numel()))


def one_minus_mean01(x: torch.Tensor) -> torch.Tensor:
    """``1 - mean(x)`` of a 0/1 tensor as XLA compiles it: the count
    times the float32 reciprocal of the size, subtracted from 1 in one
    rounding (taken in float64, where the product is exact)."""
    r = float(np.float32(1.0) / np.float32(x.numel()))
    return (1.0 - x.sum().double() * r).float()


def round_telemetry(tcfg: TelemetryConfig, tele: TelemetryState, *,
                    ids: torch.Tensor,
                    n_clients: int,
                    pkt_mask: torch.Tensor,
                    loss_mask: torch.Tensor,
                    old_vec: torch.Tensor,
                    new_vec: torch.Tensor,
                    scale: torch.Tensor,
                    qid: Optional[torch.Tensor],
                    ef_new_rows: Optional[torch.Tensor] = None,
                    arrival: Optional[torch.Tensor] = None,
                    lateness: Optional[torch.Tensor] = None,
                    qcnt: Optional[torch.Tensor] = None,
                    buf_due: Optional[torch.Tensor] = None,
                    buf_empty_due: float = 0.0,
                    down_frac: Optional[torch.Tensor] = None,
                    fec_frac: Optional[torch.Tensor] = None,
                    arq_frac: Optional[torch.Tensor] = None,
                    bud_escal: Optional[torch.Tensor] = None,
                    bud_level: Optional[torch.Tensor] = None):
    """Per-round telemetry from signals the round already produced.
    Called only when the level is not "off" (the step leaves the whole
    call out otherwise). ``qid`` is the (N,) ``bandwidth_quartiles`` of
    the static draw; None or (0,) without one.

    Returns ``(logs, new_tele)``: ``logs`` is a flat dict of
    ``"tele/..."`` keys, only those whose subsystems are built into this
    step, so an absent key in the flushed record means "the signal does
    not exist here", never zero; ``new_tele`` is the updated cumulative
    carry (the input carry at level="scalars").
    """
    C, P = pkt_mask.shape
    dev = pkt_mask.device
    # the scatter-adds as compares and sums over the cohort: one value a
    # client (cohort ids are unique) plus zeros is that value exactly,
    # so they are the reference's scatter-adds bit for bit, and under
    # the sweep's vmap one launch each (a batched index_add loops over
    # the scenarios)
    quartiles = qid is not None and qid.shape[0] == n_clients
    if quartiles or tcfg.level == "full":
        member = ids[:, None] == torch.arange(n_clients, device=dev)
        onehot = member.float().sum(0)                        # (N,)

    def scatter(v):
        return torch.where(member, v[:, None], 0.0).sum(0)

    logs: Dict[str, torch.Tensor] = {
        # the post-deadline kept-packet fraction: what the server
        # aggregates
        "tele/delivered_frac": xla_mean(pkt_mask),
        # the channel's realized drop fraction (i.i.d. draw or GE chain),
        # without the deadline's or the server mode's folding
        "tele/realized_loss": one_minus_mean01(loss_mask),
        "tele/update_norm": torch.linalg.vector_norm(new_vec - old_vec),
        "tele/debias_scale_mean": xla_mean(scale),
    }
    if quartiles:
        quart = qid[:, None] == torch.arange(N_QUARTILES, device=dev)
        logs["tele/part_quartile"] = torch.where(
            quart, onehot[:, None], 0.0).sum(0) * float(
            np.float32(1.0) / np.float32(C))
    if ef_new_rows is not None:
        logs["tele/ef_norm"] = torch.linalg.vector_norm(ef_new_rows)
    if arrival is not None:
        logs["tele/arrival_mean"] = xla_mean(arrival)
    if lateness is not None:
        b = torch.clamp(lateness, 0.0, tcfg.stale_bins - 1).to(torch.int32)
        logs["tele/stale_hist"] = (
            b[:, None] == torch.arange(tcfg.stale_bins, device=dev)
        ).float().sum(0)
    if qcnt is not None:
        logs["tele/quar_frac"] = qcnt.sum() * float(
            np.float32(1.0) / np.float32(C * P))
    if buf_due is not None and buf_due.shape[0] > 0:
        logs["tele/buf_fill"] = xla_mean((buf_due < buf_empty_due).float())
    # the full-duplex and recovery signals: the realized downlink drop
    # fraction, the packet fractions the FEC parity and the ARQ retries
    # recovered, the controller's escalations and its mean level
    if down_frac is not None:
        logs["tele/downlink_loss"] = down_frac
    if fec_frac is not None:
        logs["tele/fec_recovered"] = fec_frac
    if arq_frac is not None:
        logs["tele/arq_recovered"] = arq_frac
    if bud_escal is not None:
        logs["tele/budget_escalations"] = bud_escal
    if bud_level is not None:
        logs["tele/rec_level_mean"] = bud_level

    if tcfg.level == "full":
        # an absent signal adds zeros, which leave the carry as it is
        tele = TelemetryState(
            part_count=tele.part_count + onehot,
            arrival_mass=tele.arrival_mass + (
                scatter(arrival) if arrival is not None else onehot),
            stale_sum=tele.stale_sum + scatter(lateness)
            if lateness is not None else tele.stale_sum,
            quar_pkts=tele.quar_pkts + scatter(qcnt)
            if qcnt is not None else tele.quar_pkts,
        )
    return logs, tele


# flushed log keys -> RoundRecord fields; vector-valued keys become lists
_SCALAR_KEYS = {
    "tele/delivered_frac": "delivered_frac",
    "tele/realized_loss": "realized_loss",
    "tele/update_norm": "update_norm",
    "tele/ef_norm": "ef_norm",
    "tele/debias_scale_mean": "debias_scale_mean",
    "tele/arrival_mean": "arrival_mean",
    "tele/quar_frac": "quar_frac",
    "tele/buf_fill": "buf_fill",
    "tele/downlink_loss": "downlink_loss",
    "tele/fec_recovered": "fec_recovered",
    "tele/arq_recovered": "arq_recovered",
    "tele/budget_escalations": "budget_escalations",
    "tele/rec_level_mean": "rec_level_mean",
}
_VECTOR_KEYS = {
    "tele/part_quartile": "part_quartile",
    "tele/stale_hist": "stale_hist",
}


def records_from_logs(logs: Dict[str, np.ndarray], *, t0: int = 0,
                      scenario0: int = 0,
                      with_cohort: bool = True) -> List[RoundRecord]:
    """Demux flushed block logs into typed per-round records.

    Takes both layouts the engines flush: single-engine ``(k, ...)`` and
    the sweep's scenario-major ``(S, k, ...)`` (told apart by
    ``logs["loss"].ndim``). Records come scenario-major, rounds
    ascending: the order ``EventWriter.write_round`` enforces. ``t0`` is
    the absolute index of the block's first round; ``scenario0`` offsets
    the scenario ids of a chunked grid.
    """
    loss = np.asarray(logs["loss"])
    stacked = loss.ndim == 2
    S = loss.shape[0] if stacked else 1
    k = loss.shape[1] if stacked else loss.shape[0]

    def cell(v, s, i):
        a = np.asarray(v)
        return a[s, i] if stacked else a[i]

    out: List[RoundRecord] = []
    for s in range(S):
        for i in range(k):
            rec = RoundRecord(round=t0 + i, scenario=scenario0 + s,
                              train_loss=float(cell(logs["loss"], s, i)))
            if with_cohort and "ids" in logs:
                rec.cohort = [int(x) for x in cell(logs["ids"], s, i)]
            for key, field in _SCALAR_KEYS.items():
                if key in logs:
                    setattr(rec, field, float(cell(logs[key], s, i)))
            for key, field in _VECTOR_KEYS.items():
                if key in logs:
                    setattr(rec, field,
                            [float(x) for x in cell(logs[key], s, i)])
            out.append(rec)
    return out


def final_client_stats(tele: TelemetryState) -> Dict[str, np.ndarray]:
    """Host view of the cumulative per-client aggregates (level="full").
    A sweep's stacked state keeps its leading (S,) axis."""
    if tele.part_count.shape[-1] == 0:
        raise ValueError(
            "per-client telemetry aggregates need "
            "TelemetryConfig(level='full'): this state carries the "
            "zero-size placeholders of a lower level")
    return {name: getattr(tele, name).detach().cpu().numpy()
            for name in TelemetryState._fields}


# ---------------------------------------------------------------------------
# program-timing registry: the step caches' observability layer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ProgramStat:
    """Counters for one step family (one static signature x cohort and
    shape family), keyed by the fingerprint of the cache key the
    engine and sweep caches use."""
    fingerprint: str
    kind: str                   # "engine" | "sweep"
    key_repr: str               # full static cache key (diagnosable)
    hits: int = 0               # cache lookups that found the step
    misses: int = 0             # cache lookups that built it
    calls: int = 0              # dispatches through the timing wrapper
    compiles: int = 0           # dispatches that built or loaded a kernel
    compile_seconds: float = 0.0  # host time of those dispatches
    exec_seconds: float = 0.0     # host time of the other dispatches

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # the registry keeps the full key for collision diagnosis; event
        # streams carry a digest
        d["key_repr"] = (self.key_repr[:200] + "..."
                         if len(self.key_repr) > 200 else self.key_repr)
        return d


class ProgramRegistry:
    """Process-wide ledger of every round-step family built.

    The engine and sweep caches call ``record_lookup`` on every lookup
    with the full static key; the fingerprint is logged (the
    ``repro_torch.telemetry`` logger, DEBUG), and a fingerprint seen
    with two different keys raises ``RuntimeError`` at lookup time.
    """

    def __init__(self):
        self._stats: Dict[Any, ProgramStat] = {}

    def reset(self) -> None:
        self._stats.clear()

    def record_lookup(self, kind: str, key: Any, *, hit: bool) -> str:
        fp = fingerprint_of(key)
        st = self._stats.get((kind, fp))
        key_repr = repr(key)
        if st is None:
            st = ProgramStat(fingerprint=fp, kind=kind,
                             key_repr=key_repr)
            self._stats[(kind, fp)] = st
        elif st.key_repr != key_repr:
            raise RuntimeError(
                f"static-signature fingerprint collision: {kind} "
                f"steps for two DIFFERENT static keys share "
                f"fingerprint {fp}: cache keying is broken\n"
                f"  key A: {st.key_repr[:300]}\n"
                f"  key B: {key_repr[:300]}")
        if hit:
            st.hits += 1
        else:
            st.misses += 1
        logger.debug("%s step-cache %s: signature %s", kind,
                     "hit" if hit else "insert", fp)
        return fp

    def record_call(self, kind: str, fp: str, seconds: float,
                    compiled: bool) -> None:
        st = self._stats.get((kind, fp))
        if st is None:  # timing without a lookup (tests driving fns)
            st = ProgramStat(fingerprint=fp, kind=kind, key_repr="")
            self._stats[(kind, fp)] = st
        st.calls += 1
        if compiled:
            st.compiles += 1
            st.compile_seconds += seconds
        else:
            st.exec_seconds += seconds

    def stats(self) -> List[Dict[str, Any]]:
        return [st.as_dict() for st in self._stats.values()]

    def get(self, kind: str, fp: str) -> Optional[ProgramStat]:
        return self._stats.get((kind, fp))

    def assert_unique(self) -> None:
        """Every fingerprint maps to exactly one static key, across
        kinds too (``record_lookup`` raises at once; this re-checks the
        ledger)."""
        by_fp: Dict[str, str] = {}
        for (kind, fp), st in self._stats.items():
            if not st.key_repr:
                continue
            if fp in by_fp and by_fp[fp] != st.key_repr:
                raise RuntimeError(
                    f"fingerprint {fp} maps to two static keys")
            by_fp[fp] = st.key_repr

    def programs_for(self, kind: str) -> int:
        """Number of distinct step families built (cache misses) for one
        cache kind: the one-program-per-grid probe."""
        return sum(1 for (k, _), st in self._stats.items()
                   if k == kind and st.misses > 0)


REGISTRY = ProgramRegistry()


def _kernels_loaded() -> int:
    from repro_torch.kernels import _build
    return len(_build._LOADED)


class TimedProgram:
    """Timing wrapper around one cached step dispatcher.

    Every call is timed on the host clock and recorded against the
    step's fingerprint. The port compiles nothing per step (there is no
    jit); a call counts as a compile when a kernel library was built or
    loaded during it (``kernels/_build._LOADED`` grew), everything else
    as execution. No ``torch.cuda.synchronize()`` is added, which would
    cost the main path a sync a round: ``exec_seconds`` is host dispatch
    time, which on the card, where a round is host-bound, is close to
    the round's wall time. Attribute access falls through to the wrapped
    function.
    """

    def __init__(self, fn, kind: str, fingerprint: str):
        self._fn = fn
        self._kind = kind
        self._fp = fingerprint

    def __call__(self, *args, **kwargs):
        n0 = _kernels_loaded()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        REGISTRY.record_call(self._kind, self._fp, dt,
                             compiled=_kernels_loaded() > n0)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)
