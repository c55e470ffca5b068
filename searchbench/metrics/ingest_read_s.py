"""Mean over the window's answered requests of the seconds the ingest
spent reading the storage (``SearchService.timings[key]["ingest_read"]``:
the scan for runs with a result, and every run's trace and result
files), inside its ``ingest_read_encode`` section."""


def read(run):
    v = [r["timings"]["ingest_read"] for r in run.window
         if r["ok"] and "ingest_read" in r["timings"]]
    return sum(v) / len(v) if v else None
