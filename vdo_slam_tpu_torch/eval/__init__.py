from .results import metric_report, save_results, timing_summary

__all__ = ["metric_report", "save_results", "timing_summary"]
