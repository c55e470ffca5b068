"""Share of the traced stretch in which no operation ran on the card."""

from searchbench import trace


def read(run):
    if run.stretch is None or not run.stretch.ops:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(run.stretch)
                    / run.stretch.seconds)
