"""K2's rows-in entry (``csrc/mc_prefetch.cu``), the route of an elementwise
plugin whose rows the program evaluates before each launch: the op model's
bound for the segments and proposals of the traced fits (each proposal's
row and candidate read, the solve's operations) over K2's device time, in
%.  None where the cell's shape has a table or the trace holds no K2 time."""
from benchmark import opmodel


def read(rec):
    dev, shape = rec.get("device"), rec["shape"]
    if not dev or shape.get("table_values"):
        return None
    seconds, launches = dev["kernels_by_tag"].get("mc_prefetch", (0.0, 0))
    proposals = sum(f["total_iters"] for f in rec["fits"][:dev["fits"]])
    return opmodel.roofline_pct(
        launches, proposals, seconds,
        opmodel.k2rows_launch_bytes(shape),
        opmodel.k2rows_proposal_ops(shape),
        opmodel.k2rows_proposal_bytes(shape))
