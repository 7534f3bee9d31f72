"""Converged fits completed in the window over the window's wall
seconds: all the work over all the time."""


def read(rec):
    return sum(f["converged"] for f in rec["fits"]) / rec["window_s"]
