from .results import metric_report, save_results, timing_summary
from .velocity import velocity_report
from .visualize import draw_frame, draw_scene_flow_birdeye, draw_trajectory

__all__ = ["draw_frame", "draw_scene_flow_birdeye", "draw_trajectory",
           "metric_report", "save_results", "timing_summary",
           "velocity_report"]
