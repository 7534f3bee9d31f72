"""K2's table entry (``csrc/mc_prefetch.cu``): the op model's bound for
the segments and proposals of the traced fits over K2's device time,
in %."""
from benchmark import opmodel


def read(rec):
    dev, shape = rec.get("device"), rec["shape"]
    if not dev or not shape.get("table_values"):
        return None
    seconds, launches = dev["kernels_by_tag"].get("mc_prefetch", (0.0, 0))
    proposals = sum(f["total_iters"] for f in rec["fits"][:dev["fits"]])
    return opmodel.roofline_pct(
        launches, proposals, seconds,
        opmodel.k2_launch_bytes(shape), opmodel.k2_proposal_ops(shape),
        opmodel.k2_proposal_bytes(shape))
