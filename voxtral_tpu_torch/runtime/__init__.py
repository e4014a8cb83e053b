"""Runtime of the port: the multi-stream fleet step (`runtime/fleet.py`),
the serving runtime over it, FleetManager (`runtime/manager.py`, one
process), the step captured as one CUDA graph per shape
(`runtime/step_graph.py`), and the single-stream engine VoxStream with
its StreamConfig (`runtime/stream.py`: the bucketed path, or a B = 1
FleetManager)."""

from voxtral_tpu_torch.runtime.fleet import (
    FleetState, age_fleet_state, fleet_bootstrap, fleet_bootstrap_pcm,
    fleet_prefill, fleet_reset_slots, fleet_reset_slots_, fleet_step, fleet_step_masked,
    fleet_step_pcm, init_fleet_state, pack_wire, pcm_stream,
    pcm_stream_skew,
)
from voxtral_tpu_torch.runtime.manager import FleetManager
from voxtral_tpu_torch.runtime.step_graph import FleetStepGraphs
from voxtral_tpu_torch.runtime.stream import StreamConfig, VoxStream

__all__ = [
    "FleetManager", "FleetState", "FleetStepGraphs", "age_fleet_state", "fleet_bootstrap",
    "fleet_bootstrap_pcm", "fleet_prefill", "fleet_reset_slots", "fleet_reset_slots_",
    "fleet_step", "fleet_step_masked",
    "fleet_step_pcm", "init_fleet_state", "pack_wire", "pcm_stream",
    "pcm_stream_skew", "StreamConfig", "VoxStream",
]
