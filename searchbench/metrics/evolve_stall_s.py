"""The mean over the window's answered requests of the evolve section's
stall, at least 0: its seconds (``timings[key]["run"]``) less the
searching thread's own CPU outside its waits (``evolve_cpu``) and its
waits on the card (``evolve_wait``). The thread was off a core then,
outside those waits: runnable without the interpreter lock or a core,
or blocked in another call."""

KEYS = ("run", "evolve_cpu", "evolve_wait")


def read(run):
    v = [t["run"] - t["evolve_cpu"] - t["evolve_wait"]
         for t in (r["timings"] for r in run.window if r["ok"])
         if all(k in t for k in KEYS)]
    return max(0.0, sum(v) / len(v)) if v else None
