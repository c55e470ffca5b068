"""Kernels a generation: those launched inside the searches' evolve
phases of the traced stretch (each by the thread in the phase), over the
generations there (one B1 launch a generation)."""

from searchbench import trace


def read(run):
    if run.stretch is None:
        return None
    ks = trace.kernels_in(run.stretch, "evolve")
    gens = sum(1 for o in ks or () if trace.is_b1(o))
    return len(ks) / gens if gens else None
