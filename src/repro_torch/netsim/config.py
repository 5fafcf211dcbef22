"""Static configuration of the stateful network simulator.

``NetSimConfig`` rides inside ``FLConfig`` (``cfg.netsim``) next to
``TRAConfig``, with the reference's fields, so configurations read the
same in both packages. The fields split the way the engine splits all
knobs:

  * **static** (pick the round step's structure): ``channel`` selects
    the loss process (i.i.d. Bernoulli or Gilbert–Elliott), ``bw_ar1``
    switches the per-round AR(1) bandwidth walk on, ``deadline`` the
    deadline delivery model. They must agree across a sweep.
  * **scenario knobs** (ride ``ScenarioCtx``): ``burst_len``,
    ``good_loss``, ``bad_loss``, ``bw_rho``, ``deadline_s``. A sweep may
    grid over them: that is what makes the burst-length x loss-rate
    grid one batched program.

The downlink (server -> client broadcast) is packetised like the
uplink. ``down_channel`` is static (the Gilbert–Elliott downlink reuses
``burst_len``, ``good_loss`` and ``bad_loss``) and so is
``down_fallback``: lost broadcast packets fall back to the client's
last-received coordinates ("stale", the ``stale_model`` carry) or to
zero ("zero", the naive baseline). ``down_loss`` and
``down_deadline_s`` are scenario knobs. The broadcast deadline reads
the bandwidth carry, so it acts only with ``bw_ar1`` or ``deadline``.
"""
from __future__ import annotations

import dataclasses

CHANNELS = ("iid", "gilbert_elliott")
DOWN_CHANNELS = ("off", "iid", "gilbert_elliott")
DOWN_FALLBACKS = ("stale", "zero")


@dataclasses.dataclass(frozen=True)
class NetSimConfig:
    # -- loss channel -------------------------------------------------------
    channel: str = "iid"        # "iid" | "gilbert_elliott"
    burst_len: float = 8.0      # E[bad-state sojourn] in packets (1/p_bg)
    good_loss: float = 0.0      # per-packet loss prob in the GOOD state
    bad_loss: float = 1.0       # per-packet loss prob in the BAD state
    # -- time-varying bandwidth --------------------------------------------
    bw_ar1: bool = False        # AR(1) walk on per-client log upload speed
    bw_rho: float = 0.9         # round-to-round correlation of the walk
    # -- deadline / straggler delivery -------------------------------------
    deadline: bool = False      # drop whole uploads that miss the deadline
    deadline_s: float = 60.0    # per-round upload deadline (seconds)
    # -- downlink (server -> client broadcast) loss --------------------------
    down_channel: str = "off"   # "off" | "iid" | "gilbert_elliott"
    down_fallback: str = "stale"  # "stale" | "zero"
    down_loss: float = 0.1      # nominal downlink per-packet drop rate
    down_deadline_s: float = 0.0  # broadcast deadline (seconds), <= 0 off;
    #                               needs bw_ar1 or deadline to act

    def __post_init__(self):
        if self.channel not in CHANNELS:
            raise ValueError(f"unknown netsim channel {self.channel!r}")
        if self.down_channel not in DOWN_CHANNELS:
            raise ValueError(
                f"unknown netsim down_channel {self.down_channel!r}")
        if self.down_fallback not in DOWN_FALLBACKS:
            raise ValueError(
                f"unknown netsim down_fallback {self.down_fallback!r}")
