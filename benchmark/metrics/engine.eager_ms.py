"""The device time, per traced fit in ms, of the operations inside the
harness's ``engine.run`` span that are neither K1 nor K2
(``device_record``'s ``engine_eager_s``): on K2's rows-in route an
elementwise plugin's rows, with the draws and the init.  None without a
traced fit or where the trace holds no device time."""


def read(rec):
    dev = rec.get("device")
    if not dev or not dev.get("fits") or dev["busy_s"] <= 0.0:
        return None
    return 1e3 * dev["engine_eager_s"] / dev["fits"]
