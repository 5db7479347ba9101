"""Host-tier bytes read inside streamed subspace passes per solve
(`IOStats.pass_bytes_read` of each solve's own store), the mean over
every solve of the window, in GB."""
UNIT, BETTER, SOURCE = "GB", "lower", "program_counter"
LAYER = "subspace passes"
MOVES = "solve_s"


def read(data):
    if not data.answers:
        return None
    return sum(a.pass_bytes for a in data.answers) / len(data.answers) / 1e9
