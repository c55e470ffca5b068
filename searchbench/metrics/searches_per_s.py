"""Searches answered ``ok`` over the window's seconds, each counted by
the share of its service (from its sending to its answer) that lies
inside the window: the work the window did, so a search in flight at
the close counts for its part and the count does not jump by whole
searches."""


def read(run):
    done = 0.0
    for r in run.window:
        if r["ok"] and r["reply"] > r["sent"]:
            inside = min(r["reply"], run.t_end) - max(r["sent"], run.t_start)
            done += max(0.0, inside) / (r["reply"] - r["sent"])
    return done / run.seconds
