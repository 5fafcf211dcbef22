"""Host-side structured JSONL event stream for telemetry flushes.

The reference's schema (version 1), unchanged, so a stream the port
writes parses with either package's ``load_stream`` and renders with
``tools/flstat.py``. One event per line, every line a self-describing
JSON object with a ``kind`` tag. A stream starts with a ``header``
event stamping the environment (git commit, PyTorch and CUDA versions,
the backend and card, platform, wall-clock) and the config fingerprint
(``fingerprint_of`` of the engine's step-cache key, so an event stream
can be joined against the program-timing registry,
``core/telemetry.REGISTRY``). ``round`` events carry one
``RoundRecord`` each and must arrive with per-scenario increasing round
indices: the writer enforces that, because round-inspection tools sort
and window by them.

Stdlib and numpy only; torch is imported lazily for the stamp, so the
module parses event files without building engine state.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import time
from typing import Any, Dict, IO, Iterator, List, Optional, Union

import numpy as np

SCHEMA_VERSION = 1


def fingerprint_of(obj: Any) -> str:
    """Stable short fingerprint of any reprable object (the step caches
    key on hashable static-config tuples; their repr is the canonical
    serialisation)."""
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:16]


def _git_commit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def env_stamp(device=None) -> Dict[str, Any]:
    """Reproducibility stamp: where did these numbers come from? The
    reference's keys (``jax`` stays None here, ``backend`` is "cuda" or
    "cpu": ``device``'s type, else the card when there is one), plus
    ``torch``, ``cuda`` (``torch.version.cuda``) and ``device`` (the
    card's name, or "cpu")."""
    stamp: Dict[str, Any] = {
        "git": _git_commit(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "jax": None,
    }
    try:  # lazy: parsing event files needs no torch
        import torch
        if device is None:
            backend = "cuda" if torch.cuda.is_available() else "cpu"
        else:
            backend = torch.device(device).type
        stamp.update(
            backend=backend, torch=torch.__version__,
            cuda=torch.version.cuda,
            device=torch.cuda.get_device_name(torch.device(device or "cuda"))
            if backend == "cuda" else "cpu")
    except Exception:  # noqa: BLE001 — stamp what we can
        stamp.update(backend=None, torch=None, cuda=None, device=None)
    return stamp


@dataclasses.dataclass
class RoundRecord:
    """Typed per-round telemetry record (one scenario, one round).

    Scalar fields are what ``TelemetryConfig(level="scalars")``
    accumulates on the device; unavailable signals (``arrival_mean``
    without a deadline model, ``quar_frac`` without the fault model)
    are None, not 0: absence and zero are different facts to a
    dashboard. ``part_quartile`` orders slowest..fastest by the static
    bandwidth draw.
    """
    round: int
    scenario: int = 0
    train_loss: Optional[float] = None
    # uplink delivery (per cohort-round)
    delivered_frac: Optional[float] = None   # post-deadline kept packets
    realized_loss: Optional[float] = None    # channel-only drop fraction
    # selection / participation
    cohort: Optional[List[int]] = None       # selected client ids
    part_quartile: Optional[List[float]] = None  # (4,) cohort share per
    #                                          bandwidth quartile
    # async / deadline
    arrival_mean: Optional[float] = None     # mean effective arrival wt
    stale_hist: Optional[List[float]] = None  # lateness histogram
    buf_fill: Optional[float] = None         # live buffer-slot fraction
    # robustness
    quar_frac: Optional[float] = None        # quarantined pkt fraction
    # full duplex and recovery
    downlink_loss: Optional[float] = None    # realized broadcast drop
    fec_recovered: Optional[float] = None    # pkt fraction FEC repaired
    arq_recovered: Optional[float] = None    # pkt fraction ARQ redrew
    budget_escalations: Optional[float] = None  # controller escalations
    rec_level_mean: Optional[float] = None   # mean policy ladder level
    # update magnitudes
    update_norm: Optional[float] = None      # |params_t+1 - params_t|
    ef_norm: Optional[float] = None          # |EF rows| after update
    debias_scale_mean: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RoundRecord":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


class EventWriter:
    """Append structured events to a JSONL file.

    ``EventWriter(path, config_fingerprint=..., meta=..., device=...)``
    opens the file and writes the header event at once; use it as a
    context manager or call ``close()``. Round indices must increase
    strictly per scenario: a regression means the caller is flushing
    blocks out of order, and the writer raises instead of silently
    interleaving. ``device`` is the run's device, for the stamp.
    """

    def __init__(self, path: Union[str, IO[str]], *,
                 config_fingerprint: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None, device=None):
        if hasattr(path, "write"):
            self._f: IO[str] = path  # type: ignore[assignment]
            self._own = False
            self.path = getattr(path, "name", "<stream>")
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "w")
            self._own = True
            self.path = path
        self._last_round: Dict[int, int] = {}
        self.n_rounds_written = 0
        self.write("header", {
            "schema": SCHEMA_VERSION,
            "config_fingerprint": config_fingerprint,
            "env": env_stamp(device),
            "meta": meta or {},
        })

    def write(self, kind: str, payload: Dict[str, Any]) -> None:
        rec = {"kind": kind}
        rec.update({k: _jsonable(v) for k, v in payload.items()})
        self._f.write(json.dumps(rec) + "\n")

    def write_round(self, rec: RoundRecord) -> None:
        last = self._last_round.get(rec.scenario)
        if last is not None and rec.round <= last:
            raise ValueError(
                f"non-monotonic round index for scenario "
                f"{rec.scenario}: wrote round {last}, got {rec.round} "
                f"(blocks flushed out of order?)")
        self._last_round[rec.scenario] = rec.round
        self.n_rounds_written += 1
        self.write("round", rec.to_json())

    def write_program_stats(self, stats: List[Dict[str, Any]]) -> None:
        """Flush the program-timing registry (dispatch and cache counters
        keyed by the step-cache key's fingerprint). The registry's own
        ``kind`` field ("engine"/"sweep") is renamed ``cache`` so it
        cannot clobber the event's kind tag."""
        for s in stats:
            s = dict(s)
            s["cache"] = s.pop("kind", None)
            self.write("program", s)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self._own:
                self._f.close()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> Iterator[Dict[str, Any]]:
    """Yield every event in a JSONL stream (a malformed line, as a
    crashed writer leaves, is reported, not silently dropped)."""
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{i + 1}: malformed event line "
                    f"({e})") from e


def load_stream(path: str):
    """Parse one event file into (header, [RoundRecord], [program
    events]). Raises on a missing or duplicated header."""
    header = None
    rounds: List[RoundRecord] = []
    programs: List[Dict[str, Any]] = []
    for ev in read_events(path):
        kind = ev.get("kind")
        if kind == "header":
            if header is not None:
                raise ValueError(f"{path}: duplicate header event")
            header = ev
        elif kind == "round":
            rounds.append(RoundRecord.from_json(ev))
        elif kind == "program":
            programs.append(ev)
    if header is None:
        raise ValueError(f"{path}: no header event — not a telemetry "
                         f"event stream?")
    return header, rounds, programs
