"""The serving reference: where a served token's logit lies below the
best logit of the plain float32 forward at its position.

``served_gaps`` reads the program's served first tokens;
``control_tokens`` gives the tokens that a lower-precision forward would
serve after the same prompts (the control), which ``served_gaps`` reads
the same way.  A gap of 0 means the token is the reference's best.
"""

from __future__ import annotations

import torch

from . import model as ref


@torch.no_grad()
def served_gaps(w, m: dict, prompts: torch.Tensor, served: torch.Tensor,
                rows: int = 1) -> torch.Tensor:
    """prompts [B, P], served [B] (the token served after each prompt) ->
    gaps [B] (float32) of the reference's last-position logits."""
    ref.no_tf32()
    out = []
    for r in range(0, prompts.shape[0], rows):
        lg = ref.logits(w, m, prompts[r:r + rows], ref.Ops(),
                        positions=slice(-1, None))[:, -1]
        tok = served[r:r + rows].long()
        out.append(lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0])
    return torch.cat(out)


@torch.no_grad()
def control_tokens(w, m: dict, prompts: torch.Tensor, ops: ref.Ops,
                   rows: int = 1) -> torch.Tensor:
    """prompts [B, P] -> [B]: the token that the forward under ``ops`` puts
    first after each prompt, to be served in the program's place and read
    by ``served_gaps`` (the control)."""
    ref.no_tf32()
    out = []
    for r in range(0, prompts.shape[0], rows):
        lg = ref.logits(w, m, prompts[r:r + rows], ops,
                        positions=slice(-1, None))[:, -1]
        out.append(lg.argmax(-1))
    return torch.cat(out)
