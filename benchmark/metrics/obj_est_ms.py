"""obj_est's device time per frame, from the program's stage probe
(`FusedTracker.calibrate_stage_times`), run once after the window of a
traced run."""


def read(run):
    return (run.probe or {}).get("obj_est")
