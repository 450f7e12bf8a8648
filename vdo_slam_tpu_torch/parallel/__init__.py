from .multistream import (StreamState, make_frame_step, make_stream_state,
                          state_from_numpy)

__all__ = ["StreamState", "make_frame_step", "make_stream_state",
           "state_from_numpy"]
