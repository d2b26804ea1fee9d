"""The closed loop: each group goes to ``ingest`` as soon as the one before
it has been handed over (groups queue ahead on the device); after every
``query_every_groups`` groups of an epoch, the mix's next query, timed
from its issue.  ``"window_end": "epoch"`` ends the window with the first
whole epoch after the deadline, so the state it leaves is a whole epoch's;
otherwise it ends at the first group after the deadline."""
import time


def run(w) -> None:
    every = int(w.traffic.get("query_every_groups") or 0)
    at_epoch = w.traffic.get("window_end") == "epoch"
    while at_epoch or time.perf_counter() < w.deadline:
        g = w.ingest()
        if every and g % every == 0:
            w.query()
        if g == w.n_groups:
            if at_epoch and time.perf_counter() >= w.deadline:
                break
            w.next_epoch()
