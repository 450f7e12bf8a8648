from .multistream import (PROBE_SPANS, STAGE_SPANS, StreamState,
                          make_frame_step, make_multistream_step,
                          make_scan_probe, make_stream_state, stack_states,
                          state_from_numpy)
from .multisystem import MultiStreamSystem, make_multistream_packed_step

__all__ = ["MultiStreamSystem", "PROBE_SPANS", "STAGE_SPANS", "StreamState",
           "make_frame_step", "make_multistream_packed_step",
           "make_multistream_step", "make_scan_probe", "make_stream_state",
           "stack_states", "state_from_numpy"]
