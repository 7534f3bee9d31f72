"""The share (%) of the traced window that no device operation covers."""


def read(rec):
    dev = rec.get("device")
    if not dev or dev["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
