from .map_state import MapState
from .state import DynamicBank, FrameState, StaticBank
from .system import System
from .tracking import Tracker

__all__ = ["MapState", "FrameState", "StaticBank", "DynamicBank", "System",
           "Tracker"]
