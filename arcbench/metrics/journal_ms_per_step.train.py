"""Host time inside ``CheckpointManager.journal`` (the record's append and
its force through the replicated log), timed by the harness around the
call, per step of the window."""

LAYER = "log journal (checkpoint/manager.py journal, core/log.py append and force)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def compute(r):
    if r.get("kind") != "train" or not r.get("steps") or \
            not r.get("journal_ms"):
        return None
    return sum(r["journal_ms"]) / r["steps"]
