"""Packetizer: model updates <-> fixed-size packets, and lossy transport.

An uploaded update is the flattened parameter vector split into packets
of ``packet_floats`` float32 coordinates (256 = one 1 KiB UDP payload,
the granularity at which loss hits the update). Packet loss zeroes whole
packets and records which packets survived: the loss record TRA uses to
debias the aggregate (paper §4).

Applying the mask runs the ``packet_mask`` kernel on the card
(``kernels/packet_mask``); under ``torch.func.vmap`` over a cohort the
whole cohort is one launch.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels.packet_mask import ops as pm_ops

PACKET_FLOATS = 256  # 1 KiB of f32 payload per packet


def flatten_update(tree: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Callable]:
    """Parameter dict -> ((D,) vector, unravel), the leaves concatenated
    in the reference's ``ravel_pytree`` order (sorted keys) in their
    common dtype; ``unravel`` maps a (D,) vector back to the dict, each
    leaf in its own shape and dtype."""
    keys = sorted(tree)
    vec = torch.cat([tree[k].reshape(-1) for k in keys])
    shapes = [(k, tree[k].shape, tree[k].dtype) for k in keys]

    def unravel(v: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for k, shape, dtype in shapes:
            n = shape.numel()
            out[k] = v[off:off + n].reshape(shape).to(dtype)
            off += n
        return out

    return vec, unravel


def n_packets(n_floats: int, packet_floats: int = PACKET_FLOATS) -> int:
    return -(-n_floats // packet_floats)


def pad_to_packets(vec: torch.Tensor, packet_floats: int = PACKET_FLOATS
                   ) -> torch.Tensor:
    """(D,) -> zero-padded (P * packet_floats,)."""
    P = n_packets(vec.shape[0], packet_floats)
    return F.pad(vec, (0, P * packet_floats - vec.shape[0]))


def sample_packet_mask(key: torch.Tensor, n_pkts: int, loss_rate
                       ) -> torch.Tensor:
    """(n_pkts,) f32 mask, 1 delivered and 0 lost, bitwise the
    reference's draw from the same key."""
    return (prng.uniform(key, (n_pkts,)) >= loss_rate).float()


def apply_packet_mask(vec: torch.Tensor, pkt_mask: torch.Tensor,
                      packet_floats: int = PACKET_FLOATS) -> torch.Tensor:
    """Zero the coordinates of lost packets. vec: (D,); pkt_mask: (P,)."""
    return pm_ops.apply_packet_mask(vec, pkt_mask, packet_floats)


def lossy_upload(key: torch.Tensor, vec: torch.Tensor, loss_rate,
                 packet_floats: int = PACKET_FLOATS
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TRA upload: (masked (D,), pkt_mask (P,), kept_frac ()).

    kept_frac counts coordinates (the last packet may be partial)."""
    D = vec.shape[0]
    pkt_mask = sample_packet_mask(key, n_packets(D, packet_floats),
                                  loss_rate)
    masked = apply_packet_mask(vec, pkt_mask, packet_floats)
    kept = kept_fraction(coordinate_mask(pkt_mask, D, packet_floats))
    return masked, pkt_mask, kept


def kept_fraction(coord_mask: torch.Tensor) -> torch.Tensor:
    """Mean of a 0/1 coordinate mask over its last axis, as the
    reference's ``jnp.mean`` computes it: XLA divides by the constant D
    as a multiply by its float32 reciprocal, so the exact count times
    f32(1 / D). (A true division differs by an ulp for some D.)"""
    D = coord_mask.shape[-1]
    return coord_mask.sum(-1) * float(np.float32(1.0) / np.float32(D))


def coordinate_mask(pkt_mask: torch.Tensor, n_floats: int,
                    packet_floats: int = PACKET_FLOATS) -> torch.Tensor:
    """(P,) packet mask -> (D,) per-coordinate 0/1 mask."""
    P = pkt_mask.shape[0]
    return pkt_mask[:, None].expand(P, packet_floats).reshape(-1)[:n_floats]
