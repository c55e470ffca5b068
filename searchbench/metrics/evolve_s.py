"""Mean over the window's answered requests of the search's evolve
seconds (``SearchService.timings[key]["run"]``, the search's
``last_run_seconds``, which ends in a device sync)."""


def read(run):
    v = [r["timings"]["run"] for r in run.window
         if r["ok"] and "run" in r["timings"]]
    return sum(v) / len(v) if v else None
