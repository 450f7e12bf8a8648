from .dataset import FrameData, SequenceDataset, SyntheticDataset
from .flo import read_flo, write_flo
from .native_loader import (NativeSequenceDataset, build_native_loader,
                            read_png_native)
from .sequence_writer import write_reference_sequence
from .synthetic import SyntheticScene, make_scene

__all__ = [
    "FrameData",
    "NativeSequenceDataset",
    "SequenceDataset",
    "SyntheticDataset",
    "SyntheticScene",
    "build_native_loader",
    "make_scene",
    "read_flo",
    "read_png_native",
    "write_flo",
    "write_reference_sequence",
]
