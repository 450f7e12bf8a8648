"""The frontend's device time per frame: `prepare` alone (the depth
transform, the keypoints, grid samples or FAST and its selection, and the
candidate banks), the `frontend` region of the program's stage probe
(`FusedTracker.calibrate_stage_times`), run once after the window of a
traced run.  A program whose probe has no such region reads nothing."""


def read(run):
    return (run.probe or {}).get("frontend")
