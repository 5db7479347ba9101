"""Operator applications per solve (`EigResult.n_ops`), the mean over
every solve of the window: how much work the driver asks of the
operator for one answer."""
UNIT, BETTER, SOURCE = "count", "lower", "program_counter"
LAYER = "driver"
MOVES = "solve_s"


def read(data):
    if not data.answers:
        return None
    return sum(a.n_ops for a in data.answers) / len(data.answers)
