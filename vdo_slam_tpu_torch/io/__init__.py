from .dataset import FrameData, SequenceDataset, SyntheticDataset
from .flo import read_flo, write_flo
from .synthetic import SyntheticScene, make_scene

__all__ = [
    "FrameData",
    "SequenceDataset",
    "SyntheticDataset",
    "SyntheticScene",
    "make_scene",
    "read_flo",
    "write_flo",
]
