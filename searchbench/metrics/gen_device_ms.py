"""Device milliseconds a generation: the kernels launched inside the
searches' evolve phases (the island step's score, mutate, migrate and
select; each by the thread in the phase) of the traced stretch, over
the generations there (one B1 launch a generation)."""

from searchbench import trace


def read(run):
    if run.stretch is None:
        return None
    ks = trace.kernels_in(run.stretch, "evolve")
    gens = sum(1 for o in ks or () if trace.is_b1(o))
    if not gens:
        return None
    return 1e3 * sum(o.end - o.start for o in ks) / gens
