"""Puts the repository's root on sys.path and shrinks a cell to a size a
CPU test run can hold."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(piece):
    """*piece* (``run.load_cell``) at a CPU test's size: 40 contributions,
    2 repetitions, 8 candidates, chunks of 256, a coarse frame basis."""
    piece["config"].update(numContribs=40, numReps=2, candidatesPerStep=8,
                           chunkSteps=256, maxIterations=400_000)
    piece["traffic"].update(basis_nodes=256, strata=8, check_fits=3)
    return piece
