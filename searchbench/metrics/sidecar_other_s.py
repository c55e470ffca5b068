"""Mean over the window's answered requests of the seconds from when a
request was due to its answer, less the service's timed sections
(ingest, evolve, re-rank, save): the wire, the search's build or
checkpoint load, the key lock and the wait on other requests."""

SECTIONS = ("ingest", "run", "rerank", "save")


def read(run):
    v = [r["reply"] - r["due"] - sum(r["timings"][k] for k in SECTIONS)
         for r in run.window
         if r["ok"] and all(k in r["timings"] for k in SECTIONS)]
    return sum(v) / len(v) if v else None
