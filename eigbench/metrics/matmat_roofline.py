"""The operator's share of its roofline: over every operator application
of the window, the least time its bytes take at the card's HBM peak
(image blocks, block indices, COO entries at 12 bytes, X read once and Y
written once: `bounds.roofline.matmat_bytes`) over the time between two
CUDA events around each `matmat` call, in %. It counts the same work
however the operator carries it out."""
from eigbench.bounds import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "operator"
MOVES = "solve_s"


def read(data):
    calls = [(tag, k, ms) for tag, _, k, ms in data.matmat]
    ms = sum(c[2] for c in calls)
    if not calls or ms <= 0:
        return None
    least = sum(roofline.seconds(roofline.matmat_bytes(data.images[tag], k))
                for tag, k, _ in calls)
    return 100.0 * least / (ms / 1e3)
