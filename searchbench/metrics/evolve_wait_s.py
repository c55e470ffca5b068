"""Mean over the window's answered requests of the seconds the search's
evolve section waited on the card (``SearchService.timings[key]
["evolve_wait"]``, the search's ``last_wait_seconds``: the drained
chunks' event waits and the closing sync)."""


def read(run):
    v = [r["timings"]["evolve_wait"] for r in run.window
         if r["ok"] and "evolve_wait" in r["timings"]]
    return sum(v) / len(v) if v else None
