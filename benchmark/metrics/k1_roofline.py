"""K1 (``csrc/mc_chunk.cu``): the op model's bound for the launches and
proposals of the traced fits over K1's device time, in %."""
from benchmark import opmodel


def read(rec):
    dev, shape = rec.get("device"), rec["shape"]
    if not dev or shape["model"] not in opmodel.ROW_OPS:
        return None
    seconds, launches = dev["kernels_by_tag"].get("mc_chunk", (0.0, 0))
    proposals = sum(f["total_iters"] for f in rec["fits"][:dev["fits"]])
    return opmodel.roofline_pct(
        launches, proposals, seconds,
        opmodel.k1_launch_bytes(shape), opmodel.k1_proposal_ops(shape))
