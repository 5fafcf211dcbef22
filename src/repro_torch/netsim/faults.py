"""Uplink fault model: corruption the transport delivers.

The rest of ``netsim`` models packets that never arrive; this module
models packets and uploads that arrive wrong. A transport that skips
retransmission (the paper's TRA) also skips the integrity round-trips,
so the server must expect:

  per packet  — Gaussian payload corruption over one packet's floats,
                and single bit flips,
  per client  — NaN "device failure" uploads, sign-flipped byzantine
                uploads, and stale-echo replays (a client re-sends its
                previous genuine update).

Every rate is a scenario knob (``ScenarioCtx``), so a fault-rate x
defense grid is one batched sweep. ``FaultConfig.enabled`` is the one
static switch: off, the round step is the undefended one, unchanged.
The defenses (``DefenseConfig``) live in ``kernels/robust_agg``; their
gates are scenario knobs too, and only ``trim_k`` is static.

Fault randomness draws from ``fold_in(round_key, FAULT_FOLD)``, a fold
disjoint from the round's own draws, so enabling faults never moves
the selection, batch or loss draws. The fold layout is the reference's
(``repro/netsim/faults.py``), so the uniforms are bitwise ``jax.random``;
the Gaussian noise goes through ``prng.normal`` (``erfinv``) and is a
few ulps from JAX's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng

# fold_in tag of the fault PRNG stream ("FAUT"), applied to the round key
FAULT_FOLD = 0x46415554

# clip_norm sentinel meaning "clipping off": no masked f32 upload norm
# exceeds it, so the clip predicate is identically false.
CLIP_OFF = 1.0e30


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Uplink fault injection. ``enabled`` is static (it picks the
    step's structure); every rate may vary per sweep scenario."""
    enabled: bool = False       # static: build the fault + defense path
    corrupt_rate: float = 0.0   # P(packet hit by Gaussian corruption)
    corrupt_scale: float = 1.0  # stddev of the additive corruption
    bitflip_rate: float = 0.0   # P(packet suffers one random bit flip)
    fail_rate: float = 0.0      # P(client uploads NaN: device failure)
    flip_rate: float = 0.0      # P(client sign-flips: byzantine)
    echo_rate: float = 0.0      # P(client replays its last genuine upload)


# FaultConfig fields a sweep scenario may vary
SWEEP_VARYING_FAULT_FIELDS = ("corrupt_rate", "corrupt_scale",
                              "bitflip_rate", "fail_rate", "flip_rate",
                              "echo_rate")


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Robust-aggregation defenses (``kernels/robust_agg``). The gates
    may vary per sweep scenario; ``trim_k`` is static: it sizes the
    trimmed mean, so every scenario of a sweep must agree on it (0 leaves
    the trimmed mean out of the step)."""
    screen: bool = False     # finite screen: quarantine bad packets
    clip: bool = False       # per-client norm clipping
    clip_norm: float = 10.0  # clip threshold on the masked upload norm
    trim: bool = False       # coordinate-wise trimmed-mean aggregation
    trim_k: int = 0          # static: extremes trimmed per side


# DefenseConfig fields a sweep scenario may vary
SWEEP_VARYING_DEF_FIELDS = ("screen", "clip", "clip_norm", "trim")
# their neutral values (static_signature normalisation)
DEF_NEUTRAL = {"screen": False, "clip": False, "clip_norm": 0.0,
               "trim": False}


def clip_knob(dfn: DefenseConfig) -> float:
    """The clip scenario knob: the threshold when clipping is on, the
    CLIP_OFF sentinel (the predicate never fires) when off."""
    return float(dfn.clip_norm) if dfn.clip else CLIP_OFF


def inject_client_faults(fkey, flat, echo_rows, *, fail_rate, flip_rate,
                         echo_rate):
    """Apply per-client faults to the (C, D_up) flat uploads.

    Order: echo replay (the client ships ``echo_rows``, its previous
    genuine upload), then sign flip, then device failure (the whole row
    becomes NaN). Each fault draws its own uniform. Zero rates return
    ``flat`` bitwise (``where`` on a false predicate).
    """
    C = flat.shape[0]
    u = prng.uniform(prng.fold_in(fkey, 0), (3, C))
    out = torch.where((u[0] < echo_rate)[:, None], echo_rows, flat)
    out = torch.where((u[1] < flip_rate)[:, None], -out, out)
    return torch.where((u[2] < fail_rate)[:, None], float("nan"), out)


def inject_packet_faults(fkey, xp, deliver_mask, *, corrupt_rate,
                         corrupt_scale, bitflip_rate):
    """Apply per-packet faults to the (C, P, F) packetised uploads.

    Only delivered packets (``deliver_mask > 0.5``) are touched: a lost
    packet never reaches the server, so EF-recycled packets stay clean.
    Gaussian corruption adds ``corrupt_scale``-stddev noise over every
    float of a hit packet; the bit flip XORs one uniformly chosen bit of
    one uniformly chosen float (``flip_bit``). Zero rates return ``xp``
    bitwise.
    """
    C, P, F = xp.shape
    kg = prng.fold_in(fkey, 1)
    u = prng.uniform(prng.fold_in(kg, 0), (2, C, P))
    delivered = deliver_mask > 0.5
    hit_g = (u[0] < corrupt_rate) & delivered
    noise = corrupt_scale * prng.normal(prng.fold_in(kg, 1), (C, P, F))
    out = torch.where(hit_g[..., None], xp + noise, xp)
    hit_b = (u[1] < bitflip_rate) & delivered
    ub = prng.uniform(prng.fold_in(kg, 2), (2, C, P))
    coord = torch.clamp((ub[0] * F).to(torch.int32), max=F - 1)
    bit = torch.clamp((ub[1] * 32).to(torch.int32), max=31)
    return flip_bit_op(out.float().contiguous(), coord.contiguous(),
                       bit.contiguous(), hit_b.contiguous())


@torch.library.custom_op("repro_torch::flip_bit", mutates_args=())
def flip_bit_op(x: torch.Tensor, coord: torch.Tensor, bit: torch.Tensor,
                hit: torch.Tensor) -> torch.Tensor:
    """x: (C, P, F) f32; coord, bit: (C, P) int32; hit: (C, P) bool.
    Returns x with bit ``bit[c, p]`` of ``x[c, p, coord[c, p]]`` flipped
    where ``hit[c, p]``, every other float bitwise untouched.

    A registered op because it bit-casts float32 to int32 and back, and
    the card's PyTorch has no vmap rule for ``view(dtype)``; the vmap
    rule below folds the batch axis into C instead. Plain torch, so the
    same code serves CPU and CUDA tensors."""
    bits = x.view(torch.int32)
    # 1 << 31 is INT32_MIN in int32, whose XOR flips the sign bit
    flipped = (bits ^ (torch.ones_like(bit) << bit)[..., None]) \
        .view(torch.float32)
    lanes = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    return torch.where(hit[..., None] & (lanes == coord[..., None]),
                       flipped, x)


@flip_bit_op.register_vmap
def _flip_bit_vmap(info, in_dims, x, coord, bit, hit):
    B = info.batch_size

    def fold(t, d):
        t = t.unsqueeze(0).expand(B, *t.shape) if d is None \
            else t.movedim(d, 0)
        return t.reshape(B * t.shape[1], *t.shape[2:]).contiguous()

    out = flip_bit_op(*(fold(t, d) for t, d in
                        zip((x, coord, bit, hit), in_dims)))
    return out.reshape(B, -1, *out.shape[1:]), 0
