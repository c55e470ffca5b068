"""B1's share of its roofline in the traced stretch: the launches' least
time (``roofline.b1_least_seconds`` at the shapes of the requests served
then) over their kernel time."""

from searchbench import roofline, trace


def read(run):
    s = run.stretch
    if s is None:
        return None
    b1 = [o for o in s.ops if trace.is_b1(o)]
    shapes = [r["b1_shape"] for r in run.window
              if r["sent"] <= s.end and r["reply"] >= s.start]
    if not b1 or not shapes:
        return None
    least = sum(roofline.b1_least_seconds(*x) for x in shapes) / len(shapes)
    return 100.0 * least * len(b1) / sum(o.end - o.start for o in b1)
