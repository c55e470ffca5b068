"""Kernels an ingest launches: those each serving thread launched inside
its own ``ingest`` phases (``trace.kernels_in``), over the ingest phases
that lie wholly in the traced stretch, counting the kernels of those
phases alone. None where ``kernels_in`` reads nothing, or no ingest lies
wholly in the stretch: where the searches move in rounds longer than the
stretch (8 in flight), a stretch may hold none."""

from searchbench import trace


def read(run):
    s = run.stretch
    if s is None:
        return None
    ks = trace.kernels_in(s, "ingest")
    if ks is None:
        return None
    whole = {}
    for ids, phase, t0, t1 in s.spans:
        if phase == "ingest" and s.start <= t0 and t1 <= s.end:
            whole.setdefault(ids, []).append((t0, t1))
    if not whole:
        return None
    n = sum(1 for op in ks
            if any(t0 <= op.launch <= t1
                   for t0, t1 in whole.get(s.threads[op.tid], ())))
    return n / sum(len(v) for v in whole.values())
