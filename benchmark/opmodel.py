"""The op model of the chunk kernels K1 and K2: the bytes and operations a
launch must move and do, whatever implements it, and the least time an
H100 could take for them.

Frozen here so that a change to the program cannot change the yardstick.
Per candidate and q point: the model's row (:data:`ROW_OPS`: every +, −,
×, /, sqrt, sin, cos, exp and pow counted as one, so a lower bound) and
the two passes of the solve (:data:`SOLVE_OPS`); on K2's table entry the
blend instead of the row (a multiply-add per corner of the table's 2^A
corners, the factor, the clamp and, for an amplitude table, the square;
the worm's cross-section :data:`XS_OPS`); on K2's rows-in entry the row
is read, not computed.  The state is read and written
once a launch, the inputs and the table read once a launch; on K2 each
proposal's candidate and factor are read once.  The peaks are the H100
SXM's (NVIDIA's data sheet, at the full 700 W).

A work shape holds the sizes, taken from the cell's files alone (see
``run.work_shape``): ``model``, ``nq`` (the fit grid), ``reps``,
``contribs``, ``params`` (active parameters) and, on K2's table entry,
``table_values`` (rows × nq), ``table_axes``, ``intensity_table`` and
``cross_section``.  Launches and proposals come from the run.
"""

ROW_OPS = {"Sphere": 12, "LMADenseSphere": 55, "GaussianChain": 14,
           "SphericalCoreShell": 25}
SOLVE_OPS = 14
XS_OPS = 23
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes, n_ops):
    """The least seconds the card could take to move *n_bytes* and do
    *n_ops* float32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def state_bytes(shape):
    """The engine's state of R repetitions: the parameters (R, N, P), the
    bank (R, N, Nq), the total (R, Nq) and five scalars a repetition, four
    bytes each."""
    r, n, nq = shape["reps"], shape["contribs"], shape["nq"]
    return 4 * r * (n * shape["params"] + n * nq + nq + 5)


def k1_launch_bytes(shape):
    """A K1 chunk: the state in and out, and q, y and u."""
    return 2 * state_bytes(shape) + 3 * shape["nq"] * 4


def k1_proposal_ops(shape):
    """K1's operations per proposal (one candidate on every q point)."""
    return shape["nq"] * (ROW_OPS[shape["model"]] + SOLVE_OPS)


def k2_launch_bytes(shape):
    """A K2 table-entry segment: the state in and out, y and u, the table
    and, with a cross-section, its grid."""
    return (2 * state_bytes(shape) + 2 * shape["nq"] * 4
            + 4 * shape["table_values"]
            + (4 * shape["nq"] if shape["cross_section"] else 0))


def k2_proposal_bytes(shape):
    """K2's table entry reads each proposal's candidate (P values) and its
    factor."""
    return 4 * (shape["params"] + 1)


def k2_proposal_ops(shape):
    """K2's table entry's operations per proposal."""
    per_point = (SOLVE_OPS + 2 ** shape["table_axes"] + 2
                 + (0 if shape["intensity_table"] else 1)
                 + (XS_OPS if shape["cross_section"] else 0))
    return shape["nq"] * per_point


def k2rows_launch_bytes(shape):
    """A K2 rows-in segment (an elementwise plugin's rows, staged before the
    launch): the state in and out, and y and u."""
    return 2 * state_bytes(shape) + 2 * shape["nq"] * 4


def k2rows_proposal_bytes(shape):
    """K2's rows-in entry reads each proposal's row (Nq values) and its
    candidate (P values)."""
    return 4 * (shape["nq"] + shape["params"])


def k2rows_proposal_ops(shape):
    """K2's rows-in entry's operations per proposal: the solve alone (the
    row is the program's, made before the launch)."""
    return shape["nq"] * SOLVE_OPS


def roofline_pct(launches, proposals, kernel_s, launch_bytes, proposal_ops,
                 proposal_bytes=0):
    """The share (%) of the kernel's device time *kernel_s* that the bound
    of its *launches* and *proposals* takes, or None without device time.
    The bound is the larger of all bytes over the HBM rate and all
    operations over the float32 rate: a lower bound of the launches'
    own bounds summed."""
    if not kernel_s or kernel_s <= 0.0:
        return None
    return 100.0 * bound_s(launches * launch_bytes
                           + proposals * proposal_bytes,
                           proposals * proposal_ops) / kernel_s
