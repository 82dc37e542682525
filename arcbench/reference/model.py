"""Plain PyTorch forward passes of the benchmark's two model families, in
float32, written from the architectures' equations.  No kernel, cache or
batching of the program; nothing of the port is imported.

The weights are a flat dict keyed by tree path
(``['blocks']['l0']['ssm']['in_proj']``); a block leaf carries the layers
on its leading axis.  The functions follow the port's conventions where
they depart from the papers (noted in PERF.md): RMSNorm with a ``1 + w``
gain in place of starcoder2's LayerNorm, the tanh GELU, RoPE rotating the
two halves of a head, and no tied head for starcoder2.

``Ops`` carries the precision: ``Ops()`` computes every matrix product in
float32 with TF32 off (the reference); ``Ops(fp8=True)`` is the control,
one step below what the configuration states: both operands of every
product rounded to float8 e4m3 with a per-tensor scale first (below the
bfloat16 compute).  ``Ops(fp8=True, store_low=True)`` is a second,
coarser reading: in training it also stores every parameter one step
below its stored dtype (bfloat16 for float32, e4m3 for bfloat16).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Ops:
    def __init__(self, fp8: bool = False, store_low: bool = False):
        self.fp8, self.store_low = fp8, store_low

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the product sees it; the gradient passes straight
        through a rounding."""
        if not self.fp8:
            return x
        return x + (e4m3(x.detach()) - x.detach())

    def store(self, x: torch.Tensor, dtype: torch.dtype) -> None:
        """Round the float32 parameter ``x`` in place as it would be stored
        (``dtype`` is the configuration's); the reference keeps float32."""
        if not self.store_low:
            return
        if dtype == torch.float32:
            x.copy_(x.to(torch.bfloat16))
        else:
            x.copy_(e4m3(x))

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(x), self.q(w))

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self.q(a), self.q(b))


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor."""
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def W(w: Dict[str, torch.Tensor], *keys) -> torch.Tensor:
    return w["".join(f"[{k!r}]" for k in keys)]


def rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + g)


# ---------------------------------------------------------------------- #
# Mamba2 (state-space duality)
# ---------------------------------------------------------------------- #

def segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: Σ_{j<k<=i} a_k below the diagonal, -inf
    above it."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), -1)
    x = x.masked_fill(~low, 0.0)
    s = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """y_t = C_t·h_t, h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, from a
    zero state, evaluated chunk by chunk.  x [b,s,h,p], dt [b,s,h], A [h]
    (negative), Bm/Cm [b,s,g,n] shared by h/g heads each."""
    b, s, h, p = x.shape
    g = Bm.shape[2]
    Q = min(chunk, s)
    c = s // Q
    rep = h // g
    xd = (x * dt[..., None]).reshape(b, c, Q, h, p)
    a = (dt * A).reshape(b, c, Q, h).permute(0, 3, 1, 2)       # [b,h,c,l]
    Bc = Bm.reshape(b, c, Q, g, -1).repeat_interleave(rep, dim=3)
    Cc = Cm.reshape(b, c, Q, g, -1).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(a, dim=-1)
    L = torch.exp(segsum(a))                                    # [b,h,c,l,s]
    scores = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc) * L
    y = torch.einsum("bhcls,bcshp->bclhp", scores, xd)
    decay = torch.exp(cum[..., -1:] - cum)                      # [b,h,c,l]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(cum))
    return y.reshape(b, s, h, p)


def mamba2_layer(h, lw, m: dict, ops: Ops):
    D = m["d_model"]
    di = m["ssm_expand"] * D
    P, N, G = m["ssm_head_dim"], m["ssm_state_dim"], m["ssm_n_groups"]
    H = di // P
    eps = m["norm_eps"]
    Wp = lambda *k: lw[k]                                     # noqa: E731
    u = rms(h, Wp("ln1", "w"), eps)
    zx = ops.mm(u, Wp("ssm", "in_proj"))
    z, xi, Bm, Cm, dt = torch.split(zx, [di, di, G * N, G * N, H], dim=-1)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    cw, S = Wp("ssm", "conv_w"), conv_in.shape[1]
    K = cw.shape[0]
    xp = F.pad(conv_in, (0, 0, K - 1, 0))
    conv = sum(xp[:, j:j + S] * cw[j] for j in range(K)) + Wp("ssm", "conv_b")
    conv = F.silu(conv)
    xi, Bm, Cm = torch.split(conv, [di, G * N, G * N], dim=-1)
    b = h.shape[0]
    xh = xi.reshape(b, S, H, P)
    dt = F.softplus(dt + Wp("ssm", "dt_bias"))
    A = -torch.exp(Wp("ssm", "A_log"))
    y = ssd(xh, dt, A, Bm.reshape(b, S, G, N), Cm.reshape(b, S, G, N),
            m["ssm_chunk"])
    y = y + xh * Wp("ssm", "D_skip")[None, None, :, None]
    y = rms(y.reshape(b, S, di), Wp("ssm", "out_norm"), eps) * F.silu(z)
    return h + ops.mm(y, Wp("ssm", "out_proj"))


# ---------------------------------------------------------------------- #
# dense GQA (starcoder2)
# ---------------------------------------------------------------------- #

def rope(x, theta: float):
    """x [b,s,h,d]: the two halves of each head rotate together."""
    S, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def dense_layer(h, lw, m: dict, ops: Ops):
    D, H, KV = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or D // H
    G = H // KV
    eps = m["norm_eps"]
    Wp = lambda *k: lw[k]                                     # noqa: E731
    b, S, _ = h.shape
    u = rms(h, Wp("ln1", "w"), eps)
    q = ops.mm(u, Wp("attn", "wq").reshape(D, H * hd)).view(b, S, KV, G, hd)
    k = ops.mm(u, Wp("attn", "wk").reshape(D, KV * hd)).view(b, S, KV, hd)
    v = ops.mm(u, Wp("attn", "wv").reshape(D, KV * hd)).view(b, S, KV, hd)
    if m.get("qkv_bias"):
        q, k, v = q + Wp("attn", "bq"), k + Wp("attn", "bk"), \
            v + Wp("attn", "bv")
    q = rope(q.reshape(b, S, H, hd), m["rope_theta"])
    k = rope(k, m["rope_theta"])
    qh = q.view(b, S, KV, G, hd).permute(0, 2, 3, 1, 4)        # [b,K,G,S,d]
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)      # [b,K,S,d]
    s = ops.einsum("bkgqd,bktd->bkgqt", qh, kh) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = ops.einsum("bkgqt,bktd->bkgqd", p, vh)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, S, H * hd)
    h = h + ops.mm(o, Wp("attn", "wo").reshape(H * hd, D))
    u2 = rms(h, Wp("ln2", "w"), eps)
    n_in = 2 if m.get("gated_mlp", True) else 1
    a = ops.mm(u2, Wp("ffn", "wi").reshape(D, n_in * m["d_ff"]))
    a = a.view(b, S, n_in, m["d_ff"])
    if m.get("mlp_bias"):
        a = a + Wp("ffn", "bi")
    act = F.gelu(a[..., 0, :], approximate="tanh") if m["mlp_act"] == "gelu" \
        else F.silu(a[..., 0, :])
    if n_in == 2:
        act = act * a[..., 1, :]
    y = ops.mm(act, Wp("ffn", "wo"))
    if m.get("mlp_bias"):
        y = y + Wp("ffn", "bo")
    return h + y


LAYERS: Dict[str, Callable] = {"ssm": mamba2_layer, "dense": dense_layer}


BLOCKS = "['blocks']['l0']"


def block_key(name: str):
    """A block leaf's key within its layer: ``['blocks']['l0']['ssm']
    ['in_proj']`` -> ("ssm", "in_proj"); None for other leaves."""
    if not name.startswith(BLOCKS):
        return None
    return tuple(k.strip("'") for k in name[len(BLOCKS) + 1:-1].split("]["))


def layer_weights(w, n_layers: int):
    """Each layer's weights, {(key, ..., leaf): tensor}: the block leaves
    taken apart along their layer axis (in float32)."""
    per = [dict() for _ in range(n_layers)]
    for name, t in w.items():
        key = block_key(name)
        if key is not None:
            for i, part in enumerate(t.float().unbind(0)):
                per[i][key] = part
    return per


def hidden(w, m: dict, tokens, ops: Ops, remat: bool, layers=None):
    """The final-normed hidden states [b, s, D] of ``tokens`` [b, s];
    ``layers`` (each layer's weights) defaults to ``w``'s block leaves."""
    h = W(w, "embed", "w").float()[tokens]
    layer = LAYERS[m["family"]]
    if layers is None:
        layers = layer_weights(w, m["n_layers"])
    for lw in layers:
        if remat:
            h = checkpoint(layer, h, lw, m, ops, use_reentrant=False)
        else:
            h = layer(h, lw, m, ops)
    return rms(h, W(w, "final_norm", "w").float(), m["norm_eps"])


def head(w, m: dict) -> torch.Tensor:
    """The output head as a [D, V] matrix."""
    if m.get("tie_embeddings"):
        return W(w, "embed", "w").float().t()
    return W(w, "lm_head", "w").float()


def logits(w, m: dict, tokens, ops: Ops,
           positions: Optional[slice] = None) -> torch.Tensor:
    h = hidden(w, m, tokens, ops, remat=False)
    if positions is not None:
        h = h[:, positions]
    return ops.mm(h, head(w, m))


def nll_sum(w, m: dict, tokens, labels, ops: Ops, layers=None
            ) -> torch.Tensor:
    """Σ of the cross-entropy over labels that are not -1 (the blocks of a
    layer recomputed in the backward pass, as the program's remat does)."""
    h = hidden(w, m, tokens, ops, remat=True, layers=layers)
    lg = ops.mm(h, head(w, m))
    keep = labels != -1
    return F.cross_entropy(lg[keep], labels[keep], reduction="sum")
