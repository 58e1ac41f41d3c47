"""The plain reference of the benchmark's models, and the weights it shares
with the program.

A frozen copy of the model equations in plain PyTorch, computed in fp32 with
TF32 off: GQA attention with rotary embeddings (halves), causal and sliding
window masks, RMSNorm, SwiGLU; the Mamba2 mixer (separate projections, the
causal depthwise convolutions, the chunked SSD scan, the gated norm).  It
imports nothing of the program; it is given the weights the benchmark made
from the seed and the token ids the traffic made, never anything the
program derived from them.

``Reference(..., fp8=True)`` is the control: every weight product takes its
two operands rounded to fp8 (e4m3, one scale per tensor), the precision a
program in bf16 would be tempted to step down to.

Weights are named as the port names its parameters (``named_parameters``
of ``repro_torch.models.build``); ``make_weights`` fills them from the seed
on the card in one large draw, in the dtype they are served in.

A configuration whose block kinds these equations do not know brings its
own module, ``references/<config>.py`` (see ``harness.yardstick``).  It
reuses what is here: its ``KINDS`` (a kind's leaves, after the common
``ln1``) go to ``param_spec``; ``layout``, the leaves ``dense``, ``norm``,
``gqa_leaves`` and ``mlp_leaves``, and ``Reference`` subclassed with a
``block`` for its kinds (``gqa``, ``swiglu``, ``norm`` at hand), whose
weight products go through ``mm`` / ``prod`` so that the fp8 control covers
them too.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from .traffic import seed_words

NEG_INF = float("-inf")


# ------------------------------------------------------------------ weights

def layout(m: dict) -> List[Tuple[str, str]]:
    """(name prefix, block kind) of every layer, in the order the model runs
    them: the port's dense ``prefix`` blocks (``first_dense`` of them, kind
    ``attn``), then the groups of ``pattern``."""
    pattern = list(m.get("pattern", ["attn"]))
    first = m.get("first_dense", 0)
    groups = (m["n_layers"] - first) // len(pattern)
    return [(f"prefix.{i}.", "attn") for i in range(first)] + [
        (f"groups.{g}.b{i}.", kind) for g in range(groups)
        for i, kind in enumerate(pattern)]


def dense(m: dict, name: str, d_in: int, d_out: int, scale: float = 1.0):
    """A (d_in, d_out) weight product's leaf: N(0, (scale / sqrt(d_in))^2)
    in the parameter dtype."""
    return (name, (d_in, d_out), ("normal", scale * d_in ** -0.5),
            m["param_dtype"])


def norm(m: dict, name: str, width: int):
    """A norm's scale, at 1."""
    return (name, (width,), ("ones",), m["param_dtype"])


def gqa_leaves(pre: str, m: dict) -> list:
    """GQA's ``wq``, ``wk``, ``wv``, ``wo``."""
    d = m["d_model"]
    hd = m.get("head_dim") or d // m["n_heads"]
    hq, hkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return [dense(m, pre + "wq", d, hq), dense(m, pre + "wk", d, hkv),
            dense(m, pre + "wv", d, hkv),
            dense(m, pre + "wo", hq, d, m.get("residual_scale", 1.0))]


def attn_leaves(pre: str, m: dict) -> list:
    """GQA (``attn.*``) and, when ``d_ff`` > 0, the SwiGLU MLP (``ln2``,
    ``mlp.*``)."""
    spec = gqa_leaves(pre + "attn.", m)
    if m.get("d_ff", 0):
        spec += [norm(m, pre + "ln2", m["d_model"])] + mlp_leaves(
            pre + "mlp.", m, m["d_ff"])
    return spec


def mlp_leaves(pre: str, m: dict, width: int) -> list:
    """A SwiGLU MLP of ``width``: ``wg``, ``wu``, ``wd``."""
    d = m["d_model"]
    return [dense(m, pre + "wg", d, width), dense(m, pre + "wu", d, width),
            dense(m, pre + "wd", width, d, m.get("residual_scale", 1.0))]


def ssm_leaves(pre: str, m: dict) -> list:
    """The Mamba2 mixer's leaves, ``ssm.*``."""
    d, pd = m["d_model"], m["param_dtype"]
    di, n, h = _ssm_dims(m)
    spec = [dense(m, pre + "ssm." + leaf, d, width)
            for leaf, width in (("w_z", di), ("w_xs", di), ("w_b", n),
                                ("w_c", n), ("w_dtp", h))]
    spec += [(pre + "ssm.conv_w", (m["conv_width"], di + 2 * n),
              ("normal", 0.1), pd),
             (pre + "ssm.conv_b", (di + 2 * n,), ("zeros",), pd),
             (pre + "ssm.a_log", (h,), ("a_log",), "float32"),
             (pre + "ssm.dt_bias", (h,), ("zeros",), "float32"),
             (pre + "ssm.d_skip", (h,), ("ones",), "float32"),
             norm(m, pre + "ssm.norm_scale", di)]
    spec.append(dense(m, pre + "ssm.w_out", di, d,
                      m.get("residual_scale", 1.0)))
    return spec


KINDS = {"attn": attn_leaves, "local_attn": attn_leaves, "ssm": ssm_leaves}


def param_spec(m: dict, kinds: Optional[dict] = None
               ) -> List[Tuple[str, tuple, tuple, str]]:
    """(name, shape, init, dtype) of every parameter, in draw order.  Inits:
    ("normal", std), ("ones",), ("zeros",), ("a_log",): the port's
    distributions.  ``kinds`` (kind -> ``leaves(pre, m)``) adds a module's
    block kinds to ``KINDS``; every layer's ``ln1`` comes first."""
    d, v = m["d_model"], m["vocab"]
    kinds = dict(KINDS, **(kinds or {}))
    spec = [("tok_embed", (v, d), ("normal", 0.02), m["param_dtype"]),
            norm(m, "final_norm", d)]
    for pre, kind in layout(m):
        if kind not in kinds:
            raise ValueError(f"the reference has no block kind {kind!r}")
        spec.append(norm(m, pre + "ln1", d))
        spec += kinds[kind](pre, m)
    if not m.get("tie_embeddings", False):
        spec.append(("lm_head", (d, v), ("normal", 0.02), m["param_dtype"]))
    return spec


def _ssm_dims(m: dict):
    di = m.get("ssm_expand", 2) * m["d_model"]
    return di, m["ssm_state"], di // m.get("ssm_headdim", 64)


def weight_seed(seed: int) -> int:
    return int(seed_words(seed, 0).generate_state(1, np.uint64)[0])


@torch.no_grad()
def make_weights(m: dict, seed: int, device,
                 spec: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """Every parameter of ``spec`` (``param_spec(m)`` unless given) from
    ``seed``: the normal leaves are views of one draw on ``device`` in the
    parameter dtype, scaled in place (and cast, for a leaf of another
    dtype)."""
    spec = param_spec(m) if spec is None else spec
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    total = sum(math.prod(shape) for _, shape, init, _ in spec
                if init[0] == "normal")
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=getattr(torch, m["param_dtype"]))
    out, off = {}, 0
    for name, shape, init, dt in spec:
        dtype = getattr(torch, dt)
        if init[0] == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(init[1]).to(
                dtype)
            off += n
        elif init[0] == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:                                   # a_log: A from -1 to -16
            out[name] = torch.log(torch.linspace(
                1.0, 16.0, shape[0], device=device)).to(dtype)
    return out


# --------------------------------------------------------------- equations

def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale (its largest magnitude at 448);
    the gradient passes as it is."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta: float):
    """x (B, S, H, D): dim i turns with dim i + D/2 by position x freq."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, block: int):
    """Causal GQA, keys no more than ``window`` behind (0: all), queries
    in blocks of ``block``: q (B,S,Hq,D), k, v (B,S,Hkv,D)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    outs = []
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        k0 = max(0, q0 - window) if window > 0 else 0
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        ki = torch.arange(k0, q1, device=q.device)[None, :]
        live = ki <= qi
        if window > 0:
            live = live & (ki >= qi - window)
        qb = q[:, q0:q1].reshape(b, q1 - q0, hkv, g, d)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qb, k[:, k0:q1]) * d ** -0.5
        p = torch.softmax(sc.masked_fill(~live, NEG_INF), dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, k0:q1])
        outs.append(o.reshape(b, q1 - q0, hq, d))
    return torch.cat(outs, dim=1)


def causal_conv_silu(x, w, bias):
    """Depthwise causal conv over the sequence, then SiLU: x (B, S, C),
    w (width, C): out_t = sum_j x_{t-width+1+j} w_j."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, j:j + s] * w[j] for j in range(width))
    return F.silu(out + bias)


def ssd(x, dt, a_log, bm, cm, chunk: int):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t (A = -exp(a_log)), computed by chunks: within a chunk
    the masked quadratic form, across chunks the carried state.  x (B,S,H,P),
    dt (B,S,H), bm, cm (B,S,N).  A sequence the chunk does not divide is
    padded at its end with dt = 0, which leaves every earlier output as
    it is."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    br, cr = bm.reshape(b, nc, chunk, n), cm.reshape(b, nc, chunk, n)
    g = torch.cumsum(dtr * -torch.exp(a_log), dim=2)         # (b,c,L,h)
    live = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    gap = (g[:, :, :, None, :] - g[:, :, None, :, :]).masked_fill(
        ~live, NEG_INF)                                       # (b,c,i,j,h)
    w = torch.einsum("bcin,bcjn->bcij", cr, br)[..., None] * torch.exp(gap)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, dtr[..., None] * xr)
    to_end = torch.exp(g[:, :, -1:, :] - g) * dtr            # (b,c,L,h)
    inc = torch.einsum("bcjn,bcjh,bcjhp->bchnp", br, to_end, xr)
    state = torch.zeros(b, h, n, p, dtype=x.dtype, device=x.device)
    ys = []
    for c in range(nc):
        ys.append(y[:, c] + torch.einsum("bin,bih,bhnp->bihp", cr[:, c],
                                         torch.exp(g[:, c]), state))
        state = torch.exp(g[:, c, -1])[:, :, None, None] * state + inc[:, c]
    return torch.stack(ys, dim=1).reshape(b, nc * chunk, h, p)[:, :s]


class Reference:
    """The model in fp32 (TF32 off), over weights ``w`` (name -> tensor,
    any float dtype: each is used in fp32)."""

    def __init__(self, m: dict, w: Dict[str, torch.Tensor], *,
                 fp8: bool = False, query_block: int = 1024):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.m, self.w, self.fp8 = m, w, fp8
        self.query_block = query_block
        self.eps = m.get("norm_eps", 1e-6)

    def p(self, name):
        return self.w[name].float()

    def prod(self, x, w):
        """A weight product, in fp32 or (the control) from fp8 operands."""
        return fake_fp8(x) @ fake_fp8(w) if self.fp8 else x @ w

    def mm(self, x, name):
        return self.prod(x, self.p(name))

    def norm(self, name, x):
        return rmsnorm(x, self.p(name), self.eps)

    def gqa(self, pre, h, window):
        """GQA with rotary embeddings over the normed ``h`` (B, S, d), its
        leaves under ``pre`` (``wq``, ``wk``, ``wv``, ``wo``): the output
        before the residual add."""
        m = self.m
        b, s, d = h.shape
        hd = m.get("head_dim") or d // m["n_heads"]
        q = self.mm(h, pre + "wq").reshape(b, s, m["n_heads"], hd)
        k = self.mm(h, pre + "wk").reshape(b, s, m["n_kv_heads"], hd)
        v = self.mm(h, pre + "wv").reshape(b, s, m["n_kv_heads"], hd)
        theta = m.get("rope_theta", 10000.0)
        o = attention(rope(q, theta), rope(k, theta), v, window,
                      self.query_block)
        return self.mm(o.reshape(b, s, -1), pre + "wo")

    def swiglu(self, pre, h):
        """The SwiGLU MLP over the normed ``h``, its leaves under ``pre``
        (``wg``, ``wu``, ``wd``)."""
        u = F.silu(self.mm(h, pre + "wg")) * self.mm(h, pre + "wu")
        return self.mm(u, pre + "wd")

    def attn_block(self, pre, x, window):
        x = x + self.gqa(pre + "attn.", self.norm(pre + "ln1", x), window)
        if self.m.get("d_ff", 0):
            x = x + self.swiglu(pre + "mlp.", self.norm(pre + "ln2", x))
        return x

    def ssm_block(self, pre, x):
        m = self.m
        b, s, _ = x.shape
        di, n, nh = _ssm_dims(m)
        h = rmsnorm(x, self.p(pre + "ln1"), self.eps)
        z = self.mm(h, pre + "ssm.w_z")
        cw, cb = self.p(pre + "ssm.conv_w"), self.p(pre + "ssm.conv_b")
        xs = causal_conv_silu(self.mm(h, pre + "ssm.w_xs"), cw[:, :di],
                              cb[:di])
        bm = causal_conv_silu(self.mm(h, pre + "ssm.w_b"), cw[:, di:di + n],
                              cb[di:di + n])
        cm = causal_conv_silu(self.mm(h, pre + "ssm.w_c"), cw[:, di + n:],
                              cb[di + n:])
        dt = F.softplus(self.mm(h, pre + "ssm.w_dtp")
                        + self.p(pre + "ssm.dt_bias"))
        xh = xs.reshape(b, s, nh, -1)
        y = ssd(xh, dt, self.p(pre + "ssm.a_log"), bm, cm, m["ssm_chunk"])
        y = y + xh * self.p(pre + "ssm.d_skip")[:, None]
        y = rmsnorm(y.reshape(b, s, di) * F.silu(z),
                    self.p(pre + "ssm.norm_scale"), self.eps)
        return x + self.mm(y, pre + "ssm.w_out")

    def block(self, pre, kind, x):
        """One layer; a module's subclass adds its kinds here."""
        if kind == "ssm":
            return self.ssm_block(pre, x)
        if kind not in ("attn", "local_attn"):
            raise ValueError(f"the reference has no block kind {kind!r}")
        window = self.m.get("window", 0) if kind == "local_attn" else 0
        return self.attn_block(pre, x, window)

    def hidden(self, ids, remat: bool = False):
        """ids (B, S) -> the final norm's output (B, S, d)."""
        x = self.p("tok_embed")[ids]
        for pre, kind in layout(self.m):
            if remat:
                x = ckpt.checkpoint(self.block, pre, kind, x,
                                    use_reentrant=False)
            else:
                x = self.block(pre, kind, x)
        return rmsnorm(x, self.p("final_norm"), self.eps)

    def logits(self, h):
        tied = self.m.get("tie_embeddings", False)
        return self.prod(h, self.p("tok_embed").T if tied
                         else self.p("lm_head"))

    @torch.no_grad()
    def last_logits(self, ids) -> torch.Tensor:
        """ids (S,) -> the last position's logits (V,), fp32."""
        h = self.hidden(ids[None])
        return self.logits(h[:, -1])[0]

    def xent_sum(self, tokens, labels):
        """Summed token cross entropy of a (B, S) batch."""
        logits = self.logits(self.hidden(tokens, remat=True))
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long(), reduction="sum")


def follow_training(m: dict, w: Dict[str, torch.Tensor],
                    batches: Iterable[Dict[str, torch.Tensor]], *, lr: float,
                    weight_decay: float, max_grad_norm: float,
                    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                    eps_root: float = 1e-8, fp8: bool = False,
                    reference: type = None) -> dict:
    """AdamW steps in fp32 from the weights ``w`` over ``batches`` (each a
    dict of (B, S) ``tokens`` and ``labels`` on the card), a row at a time:
    the mean token cross entropy over the batch, its gradients clipped to
    a global norm of ``max_grad_norm``, then the update.  Returns each
    step's loss, each leaf's norm of the first clipped gradient and of its
    change over all the steps.  ``reference``: the equations' class
    (``Reference`` unless given)."""
    params = {k: t.float().clone().requires_grad_(True) for k, t in w.items()}
    ref = (reference or Reference)(m, params, fp8=fp8)
    mu = {k: torch.zeros_like(t) for k, t in params.items()}
    nu = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, first_grad = [], {}
    for step, batch in enumerate(batches, start=1):
        tokens, labels = batch["tokens"], batch["labels"]
        count = labels.numel()
        loss = 0.0
        for r in range(tokens.shape[0]):
            part = ref.xent_sum(tokens[r:r + 1], labels[r:r + 1]) / count
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = {k: t.grad for k, t in params.items()}
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            clip = torch.clamp(max_grad_norm / torch.clamp(norm, min=1e-12),
                               max=1.0)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for k, t in params.items():
                g = grads[k] * clip
                if step == 1:
                    first_grad[k] = float(torch.linalg.vector_norm(g))
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2 + eps_root)
                                       + eps) + weight_decay * t
                t.sub_(lr * upd)
                t.grad = None
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(t - w[k].float()))
                  for k, t in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
