from .results import metric_report, save_results, timing_summary
from .velocity import velocity_report

__all__ = ["metric_report", "save_results", "timing_summary",
           "velocity_report"]
