"""Packetizer: a flat model update split into packets of
``packet_floats`` float32 coordinates (256 = one 1 KiB UDP payload, the
granularity at which loss hits the update)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

PACKET_FLOATS = 256  # 1 KiB of f32 payload per packet


def n_packets(n_floats: int, packet_floats: int = PACKET_FLOATS) -> int:
    return -(-n_floats // packet_floats)


def pad_to_packets(vec: torch.Tensor, packet_floats: int = PACKET_FLOATS
                   ) -> torch.Tensor:
    """(D,) -> zero-padded (P * packet_floats,)."""
    P = n_packets(vec.shape[0], packet_floats)
    return F.pad(vec, (0, P * packet_floats - vec.shape[0]))


def coordinate_mask(pkt_mask: torch.Tensor, n_floats: int,
                    packet_floats: int = PACKET_FLOATS) -> torch.Tensor:
    """(P,) packet mask -> (D,) per-coordinate 0/1 mask."""
    return torch.repeat_interleave(pkt_mask, packet_floats)[:n_floats]
