"""The float64 post pass and histograms (``api.histogram_all``): the
harness's synchronized span, mean per fit, in ms."""


def read(rec):
    spans = rec.get("spans", {}).get("post")
    return 1e3 * sum(spans) / len(spans) if spans else None
