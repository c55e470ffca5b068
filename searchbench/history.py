"""Recorded runs of a ZooKeeper ensemble's leader election, written as
namazu's naive storage, from a seed.

A campaign's storage is what namazu's control plane leaves behind: a
directory with ``storage.json`` (``{"type": "naive", "next_run": N}``)
and one ``%08x`` directory a run holding ``trace.json`` (the run's
actions, each with its cause event's class, replay hint, arrival and
release time) and ``result.json`` (outcome, metadata with the hint
space).

The runs follow upstream namazu's recorded ZOOKEEPER-2212 hunt
(``example/zk-found-2212.ryu/example-result.20150805``: 4 runs, 151
intercepted FLE notifications, 48 in the first run, 2 runs failed),
whose events the importer turns into replay hints of the form
``zk3->zk1:fle:notif:state=looking:leader=3:zxid=0x100000000:epoch=1:
peerEpoch=1``. The ensemble (``history`` in a configuration file) has
``servers`` nodes; a run is one election: every server starts
``looking`` and votes for itself, each notification goes from one
server to another, a server that hears a higher vote votes for it, and
once a server has heard every other server vote for the highest id it
settles as ``leading`` (that id) or ``following``; settled servers keep
answering. The run's election epoch is ``1 + run % epochs``, and its
zxid the epoch's first (a fresh ensemble each run). A run
holds ``events[run % len(events)]`` notifications. Arrivals are spaced
uniformly over ``[0, max_gap_s]`` and each release lags its arrival by
a uniform share of ``max_delay_s`` (the random policy's delay, which
paced the recorded runs); the last of every ``failure_every`` runs
failed.

Every run of every campaign comes from its own stream of
``numpy.random.default_rng([seed, campaign, run])``, so the same seed
writes the same bytes, and any seed writes the same sizes.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

#: the hint space the port's ingest reads (runs stamped otherwise are
#: skipped by the search)
HINT_SPACE = "flow-v2"
#: the first run's start time (a wall clock in seconds), one minute a run
T0 = 1.7e9
RUN_SPACING_S = 60.0


def is_failure(h: dict, run: int) -> bool:
    every = int(h["failure_every"])
    return run % every == every - 1


def election(h: dict, rng: np.random.Generator, n: int,
             epoch: int) -> List[str]:
    """The hints of ``n`` notifications of one election."""
    servers = int(h["servers"])
    top = servers
    vote = {s: s for s in range(1, servers + 1)}
    heard = {s: set() for s in vote}
    settled = {s: False for s in vote}
    out = []
    for _ in range(n):
        src = int(rng.integers(1, servers + 1))
        dst = int(rng.integers(1, servers))
        dst += dst >= src
        if settled[src]:
            state = "leading" if src == top else "following"
        else:
            state = "looking"
        leader = vote[src]
        out.append(f"zk{src}->zk{dst}:fle:notif:state={state}:"
                   f"leader={leader}:zxid={epoch << 32:#x}:"
                   f"epoch={epoch}:peerEpoch={epoch}")
        if leader > vote[dst]:
            vote[dst] = leader
        if leader == top:
            heard[dst].add(src)
        if vote[dst] == top and len(heard[dst] | {dst}) == servers:
            settled[dst] = True
    return out


def run_actions(h: dict, seed: int, campaign: int, run: int) -> List[dict]:
    """The recorded actions of run ``run`` of campaign ``campaign``."""
    rng = np.random.default_rng([seed, campaign, run])
    sizes = h["events"]
    n = int(sizes[run % len(sizes)])
    hints = election(h, rng, n, 1 + run % int(h["epochs"]))
    arrivals = (rng.random(n) * float(h["max_gap_s"])).cumsum()
    released = arrivals + rng.random(n) * float(h["max_delay_s"])
    t0 = T0 + RUN_SPACING_S * run
    tag = f"{campaign:x}-{run:x}"
    return [{
        "type": "action", "class": "EventAcceptanceAction",
        "entity": hint.split("->")[0], "uuid": f"a{tag}-{i:x}",
        "option": {}, "event_uuid": f"e{tag}-{i:x}",
        "event_class": "PacketEvent", "event_hint": hint,
        "event_arrived": t0 + float(a), "triggered_time": t0 + float(r),
    } for i, (hint, a, r) in enumerate(zip(hints, arrivals, released))]


def write_run(run_dir: str, h: dict, seed: int, campaign: int,
              run: int) -> None:
    """One run's directory: its trace, then its result."""
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "trace.json"), "w") as f:
        json.dump(run_actions(h, seed, campaign, run), f)
    with open(os.path.join(run_dir, "result.json"), "w") as f:
        json.dump({"successful": not is_failure(h, run),
                   "required_time": RUN_SPACING_S,
                   "metadata": {"hint_space": HINT_SPACE}}, f)


def write_next_run(storage: str, n: int) -> None:
    """Point ``storage.json`` at ``n`` runs, atomically."""
    tmp = os.path.join(storage, "storage.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"type": "naive", "next_run": n}, f)
    os.replace(tmp, os.path.join(storage, "storage.json"))


def append_run(storage: str, ahead: str, n: int) -> bool:
    """Move staged run ``n`` into the storage (a rename) and count it;
    False when no run was staged that far."""
    src = os.path.join(ahead, f"{n:08x}")
    if not os.path.isdir(src):
        return False
    os.rename(src, os.path.join(storage, f"{n:08x}"))
    write_next_run(storage, n + 1)
    return True
