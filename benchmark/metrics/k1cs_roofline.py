"""K1's core-shell row (``csrc/mc_chunk.cu``, model 3): ``k1_roofline``'s
reading, the op model's bound for the launches and proposals of the
traced fits (25 operations a candidate and point for the row) over K1's
device time, in %, in the cells whose model is SphericalCoreShell.  None
elsewhere, or where the trace holds no K1 time."""
from benchmark import run


def read(rec):
    if rec["shape"]["model"] != "SphericalCoreShell":
        return None
    return run.reader("k1_roofline")(rec)
