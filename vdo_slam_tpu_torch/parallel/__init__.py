from .multistream import (StreamState, make_frame_step,
                          make_multistream_step, make_stream_state,
                          stack_states, state_from_numpy)
from .multisystem import MultiStreamSystem, make_multistream_packed_step

__all__ = ["MultiStreamSystem", "StreamState", "make_frame_step",
           "make_multistream_packed_step", "make_multistream_step",
           "make_stream_state", "stack_states", "state_from_numpy"]
