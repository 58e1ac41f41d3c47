"""The reference module of the CPU tests' ``toy-moe`` configuration, which
``toy.write_root`` copies to ``references/toy-moe.py`` of its toy root: how
a configuration brings a block kind the default equations do not know (the
port's ``moe``: GQA attention, then a routed SwiGLU expert FFN with a shared
expert) as one new file.

It gives only what differs from ``reference.py`` and ``counts.py``: the
``moe`` kind's leaves (``KINDS``), its equations on a subclass of
``Reference``, and the work counts of a model whose layers use ``top_k`` of
their experts and all take the flash kernel.  It also replaces a default
kind: the dense ``prefix`` blocks (kind ``attn`` in the default layout) take
their leaves and equations from here, as a model whose prefix is not the
default GQA block would.  The router is softmax top-k, ties to the lower
expert, the k gates normalised; no token is dropped (the configuration's
capacity holds every assignment).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import counts, reference


def expert_ff(m: dict) -> int:
    return m.get("d_expert") or m["d_ff"]


def moe_leaves(pre: str, m: dict) -> list:
    """GQA, ``ln2``, then ``moe.w_router`` (d, E) in fp32, the experts'
    ``we_g``, ``we_u`` (E, d, F) and ``we_d`` (E, F, d), and the shared
    experts' MLP ``moe.shared`` of width F x n_shared."""
    d, e, f = m["d_model"], m["n_experts"], expert_ff(m)
    rs = m.get("residual_scale", 1.0)
    pd = m["param_dtype"]
    spec = reference.gqa_leaves(pre + "attn.", m)
    spec += [reference.norm(m, pre + "ln2", d),
             (pre + "moe.w_router", (d, e), ("normal", d ** -0.5),
              "float32"),
             (pre + "moe.we_g", (e, d, f), ("normal", d ** -0.5), pd),
             (pre + "moe.we_u", (e, d, f), ("normal", d ** -0.5), pd),
             (pre + "moe.we_d", (e, f, d), ("normal", rs * d ** -0.5), pd)]
    if m.get("n_shared_experts", 0):
        spec += reference.mlp_leaves(pre + "moe.shared.", m,
                                     f * m["n_shared_experts"])
    return spec


def prefix_leaves(pre: str, m: dict) -> list:
    """A dense prefix block after its ``ln1``: GQA, ``ln2`` and a SwiGLU
    MLP of ``d_ff``."""
    return (reference.gqa_leaves(pre + "attn.", m)
            + [reference.norm(m, pre + "ln2", m["d_model"])]
            + reference.mlp_leaves(pre + "mlp.", m, m["d_ff"]))


KINDS = {"moe": moe_leaves, "attn": prefix_leaves}


class Reference(reference.Reference):
    def block(self, pre, kind, x):
        if kind not in KINDS:
            return super().block(pre, kind, x)
        x = x + self.gqa(pre + "attn.", self.norm(pre + "ln1", x), 0)
        h = self.norm(pre + "ln2", x)
        return x + (self.moe(pre + "moe.", h) if kind == "moe"
                    else self.swiglu(pre + "mlp.", h))

    def moe(self, pre, h):
        """Each token through its top-k experts, weighted by its normalised
        gates, plus the shared experts."""
        m = self.m
        b, s, d = h.shape
        ht = h.reshape(b * s, d)
        probs = torch.softmax(self.mm(ht, pre + "w_router"), dim=-1)
        gates, chosen = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
        gates, chosen = gates[:, :m["top_k"]], chosen[:, :m["top_k"]]
        gates = gates / gates.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(ht)
        if m.get("n_shared_experts", 0):
            out = out + self.swiglu(pre + "shared.", ht)
        wg, wu, wd = (self.p(pre + n) for n in ("we_g", "we_u", "we_d"))
        for e in range(m["n_experts"]):
            rows, slot = torch.nonzero(chosen == e, as_tuple=True)
            if rows.numel():
                xe = ht[rows]
                y = self.prod(F.silu(self.prod(xe, wg[e]))
                              * self.prod(xe, wu[e]), wd[e])
                out = out.index_add(0, rows, y * gates[rows, slot, None])
        return out.reshape(b, s, d)


# --------------------------------------------------------------- work counts

def layer_active_params(m: dict, kind: str) -> int:
    """Weights of one layer that multiply a token's activations: a ``moe``
    layer's attention, router, top_k routed and the shared experts."""
    if kind != "moe":
        return counts.layer_matmul_params(m, kind)
    d, hd = m["d_model"], counts.head_dim(m)
    attn = d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2
    experts = m["top_k"] + m.get("n_shared_experts", 0)
    return attn + d * m["n_experts"] + experts * 3 * d * expert_ff(m)


def active_params(m: dict) -> int:
    return sum(layer_active_params(m, k) for k in counts.block_kinds(m))


def attention_layers(m: dict) -> int:
    """Every layer's self-attention is GQA, and may take the flash
    kernel."""
    return len(counts.block_kinds(m))


def attention_calls(m: dict, s: int) -> list:
    """One flash call a layer: causal GQA of the model's heads, no
    window."""
    hq, hkv, d = m["n_heads"], m["n_kv_heads"], counts.head_dim(m)
    call = (counts.attention_flops(1, hq, s, d, True, 0),
            counts.attention_bytes(1, hq, hkv, s, d))
    return [call] * attention_layers(m)


def attention_work(m: dict, s: int, b: int = 1) -> float:
    return attention_layers(m) * counts.attention_flops(
        b, m["n_heads"], s, counts.head_dim(m), True, 0)


def prefill_flops(m: dict, s: int) -> float:
    """One B=1 request of ``s`` tokens: the active weight products at every
    position, the head at the last one, causal attention in every layer."""
    return (2.0 * active_params(m) * s + 2.0 * m["d_model"] * m["vocab"]
            + attention_work(m, s))


def train_flops(m: dict, b: int, s: int) -> float:
    """6 x (active weights and the head) x tokens and three times
    attention's forward work."""
    weights = active_params(m) + m["d_model"] * m["vocab"]
    return 6.0 * weights * b * s + 3.0 * attention_work(m, s, b)
