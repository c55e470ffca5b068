"""Mean over the window's answered requests of the seconds the ingest
spent encoding the runs it read (``SearchService.timings[key]
["ingest_encode"]``: each run's two time views and a failure's seed
table), inside its ``ingest_read_encode`` section."""


def read(run):
    v = [r["timings"]["ingest_encode"] for r in run.window
         if r["ok"] and "ingest_encode" in r["timings"]]
    return sum(v) / len(v) if v else None
