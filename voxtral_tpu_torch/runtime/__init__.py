"""Serving runtime of the port: the multi-stream fleet step
(`runtime/fleet.py`). FleetManager and VoxStream are not ported yet."""

from voxtral_tpu_torch.runtime.fleet import (
    FleetState, age_fleet_state, fleet_bootstrap, fleet_bootstrap_pcm,
    fleet_prefill, fleet_reset_slots, fleet_step, fleet_step_masked,
    fleet_step_pcm, init_fleet_state, pack_wire, pcm_stream,
    pcm_stream_skew,
)

__all__ = [
    "FleetState", "age_fleet_state", "fleet_bootstrap", "fleet_bootstrap_pcm",
    "fleet_prefill", "fleet_reset_slots", "fleet_step", "fleet_step_masked",
    "fleet_step_pcm", "init_fleet_state", "pack_wire", "pcm_stream",
    "pcm_stream_skew",
]
