"""``McSASEngine.run``: the engine's own timer (``EngineResult.elapsed``,
which ends in a host read of χ²), mean per fit, in ms."""


def read(rec):
    fits = rec["fits"]
    return 1e3 * sum(f["engine_s"] for f in fits) / len(fits) if fits else None
