"""Mean over the window's answered requests of the service's ingest
seconds (``SearchService.timings[key]["ingest"]``, read after each
answer)."""


def read(run):
    v = [r["timings"]["ingest"] for r in run.window
         if r["ok"] and "ingest" in r["timings"]]
    return sum(v) / len(v) if v else None
