"""``train_mfu`` in the cell that checkpoints through the log."""

LAYER = "model step (train/step.py, models/model.py forward_train and autograd)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "ckpt_train_tokens_per_s"

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)


def compute(r):
    if r.get("kind") != "train" or not r.get("tokens_per_s"):
        return None
    return 100.0 * r["flops_per_token"] * r["tokens_per_s"] / PEAK_FLOPS
