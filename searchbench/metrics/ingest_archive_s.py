"""Mean over the window's answered requests of the ingest's archive
section (``SearchService.timings[key]["ingest_archive"]``, the
``ingest_archive`` phase: the pairs' refit, the seed genomes and every
run's feature rows, a device round trip a run)."""


def read(run):
    v = [r["timings"]["ingest_archive"] for r in run.window
         if r["ok"] and "ingest_archive" in r["timings"]]
    return sum(v) / len(v) if v else None
