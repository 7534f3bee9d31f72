"""Engine construction for a new frame (``api._cached_engine``): the
harness's synchronized span, mean per fit, in ms."""


def read(rec):
    spans = rec.get("spans", {}).get("api.setup")
    return 1e3 * sum(spans) / len(spans) if spans else None
