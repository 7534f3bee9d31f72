"""K2's table entry with the worm's cross-section factor
(``csrc/mc_prefetch.cu``): the op model's bound for the segments and
proposals of the traced fits, two table axes and the factor of each
point priced in, over K2's device time, in %.  None where the cell's
table declares no cross-section or the trace holds no K2 time."""
from benchmark import opmodel


def read(rec):
    dev, shape = rec.get("device"), rec["shape"]
    if not dev or not shape.get("cross_section"):
        return None
    seconds, launches = dev["kernels_by_tag"].get("mc_prefetch", (0.0, 0))
    proposals = sum(f["total_iters"] for f in rec["fits"][:dev["fits"]])
    return opmodel.roofline_pct(
        launches, proposals, seconds,
        opmodel.k2_launch_bytes(shape), opmodel.k2_proposal_ops(shape),
        opmodel.k2_proposal_bytes(shape))
