"""From ``save_async``'s return to its future's completion (encoding, CRC32,
the store puts, the manifest and its force through the log), mean over
the window's saves."""

LAYER = "background save (checkpoint/manager.py save: encode, CRC32, store puts, manifest force)"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "ckpt_train_tokens_per_s"


def compute(r):
    s = r.get("save_s")
    return sum(s) / len(s) if s else None
