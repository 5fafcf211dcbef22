"""Stateful network simulator: bursty Gilbert–Elliott loss, the AR(1)
bandwidth walk, deadline delivery, the fault model, downlink broadcast
loss and the recovery-policy family, as scenario axes of the round."""
from repro_torch.netsim.bandwidth import (BW_FOLD, init_logbw,
                                          logbw_round_step)
from repro_torch.netsim.channel import (CH_INIT_FOLD, DOWN_INIT_FOLD,
                                        ge_transition_probs,
                                        init_channel_state,
                                        sample_ge_mask_numpy,
                                        stationary_bad_frac)
from repro_torch.netsim.config import (CHANNELS, DOWN_CHANNELS,
                                       DOWN_FALLBACKS, NetSimConfig)
from repro_torch.netsim.delivery import (INFEASIBLE_SECS, MAX_LATENESS,
                                         arrival_lateness,
                                         deadline_delivered,
                                         grace_staleness,
                                         round_upload_seconds)
from repro_torch.netsim.faults import (CLIP_OFF, FAULT_FOLD, DefenseConfig,
                                       FaultConfig, clip_knob,
                                       inject_client_faults,
                                       inject_packet_faults)
from repro_torch.netsim.recovery import (RECOVERY_POLICIES, RecoveryConfig,
                                         arq_residual_mask, arq_sends,
                                         fec_groups, fec_parity_mask,
                                         fec_sends, recovery_onehot,
                                         recovery_upload_seconds,
                                         residual_loss_rate,
                                         residual_rate_mixed,
                                         retransmit_sends)
from repro_torch.netsim.state import NetSimState, init_net_state

__all__ = [
    "BW_FOLD", "CHANNELS", "CH_INIT_FOLD", "CLIP_OFF", "DOWN_CHANNELS",
    "DOWN_FALLBACKS", "DOWN_INIT_FOLD", "DefenseConfig", "FAULT_FOLD",
    "FaultConfig", "INFEASIBLE_SECS", "MAX_LATENESS", "NetSimConfig",
    "NetSimState", "RECOVERY_POLICIES", "RecoveryConfig",
    "arq_residual_mask", "arq_sends", "arrival_lateness", "clip_knob",
    "deadline_delivered", "fec_groups", "fec_parity_mask", "fec_sends",
    "ge_transition_probs", "grace_staleness", "init_channel_state",
    "init_logbw", "init_net_state", "inject_client_faults",
    "inject_packet_faults", "logbw_round_step", "recovery_onehot",
    "recovery_upload_seconds", "residual_loss_rate", "residual_rate_mixed",
    "retransmit_sends", "round_upload_seconds", "sample_ge_mask_numpy",
    "stationary_bad_frac",
]
