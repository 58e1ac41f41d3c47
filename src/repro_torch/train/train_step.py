"""Training step: loss -> grads -> (optional int8 error-feedback
compression) -> AdamW, with gradient-accumulation microbatching.

Counterpart of ``repro/train/train_step.py``.  The state is a plain dict:
``params`` (the model's named parameters, the same tensor objects, so an
update changes the model), ``opt`` (``optim.adamw_init``, or with int8
moments ``optim.quantized_moments.q8nd_init``) and, with
compressed gradients, ``residuals``.  The reference's step is a pure
function for ``jax.jit``; here it runs eagerly and updates the state in
place, returning it in the reference's ``(state, metrics)`` shape.
``models/convert.state_to_jax`` gives the reference's layout of a state.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Mapping, Optional

import torch

from ..distributed.sharding import split_rows, zeros_as
from ..models import LanguageModel
from ..models.convert import split_stacked
from ..obs.compute import compute_span
from ..optim import adamw_update, error_feedback_update
from ..optim.adamw import adamw_init
from ..optim.grad_compression import init_residuals
from ..optim.quantized_moments import q8nd_adamw_update, q8nd_init

# Second-moment floor (optax-style eps_root, inside the sqrt) used by the
# train substrate: sqrt(1e-8) = 1e-4 bounds the first-step update's
# sensitivity to fp32 gradient noise, so grad-accumulated microbatch steps
# match full-batch steps instead of amplifying round-off through Adam's
# sign(g)-like cold-start update.
EPS_ROOT = 1e-8


def _compress(grads: Mapping[str, torch.Tensor],
              residuals: Mapping[str, torch.Tensor]):
    """``error_feedback_update`` over the reference's leaves: it quantizes
    each leaf of its params pytree with one scale, and a block leaf there is
    stacked over the groups (or the dense prefix blocks), so the group
    copies of a block parameter (``groups.<g>.b0.attn.wq`` for every g)
    share one scale here too."""
    leaves = defaultdict(list)
    for name in grads:
        leaf, i = split_stacked(name) or (name, 0)
        leaves[leaf].append((i, name))
    deq, res = error_feedback_update(
        {k: torch.stack([grads[n] for _, n in sorted(v)])
         for k, v in leaves.items()},
        {k: torch.stack([residuals[n] for _, n in sorted(v)])
         for k, v in leaves.items()})
    new_grads, new_res = {}, {}
    for k, v in leaves.items():
        for i, (_, name) in enumerate(sorted(v)):
            new_grads[name], new_res[name] = deq[k][i], res[k][i]
    return new_grads, new_res


def init_state(model: LanguageModel,
               generator: Optional[torch.Generator] = None, *,
               moment_dtype: Optional[str] = None,
               compress_grads: bool = False) -> Dict:
    """Fill the model's parameters from ``generator`` (None keeps the ones it
    holds, e.g. loaded by ``convert.params_from_jax``), turn gradients on
    for them, and return the train state.

    moment_dtype: None (the parameters' dtype), "float32", "bfloat16", or
    "int8" (block-quantized 8-bit-Adam moments in the shape-preserving
    layout, ``optim.quantized_moments``; a per-group 0-d parameter's
    moments are quantized over its stacked leaf, as the reference's)."""
    if generator is not None:
        model.init(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    if moment_dtype == "int8":
        opt = q8nd_init(params)
    else:
        opt = adamw_init(params, moment_dtype=moment_dtype)
    state = {"params": params, "opt": opt}
    if compress_grads:
        state["residuals"] = init_residuals(params)
    return state


def make_train_step(model: LanguageModel, *, lr, microbatches: int = 1,
                    compress_grads: bool = False,
                    weight_decay: float = 0.1,
                    max_grad_norm: float = 1.0,
                    accum_dtype: str = "float32",
                    q8_moments: bool = False) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: tensors on the model's device, ``tokens`` and ``labels`` (B, S).
    accum_dtype: gradient-accumulation buffer dtype (bf16 halves the
    accumulator memory).
    q8_moments: block-quantized int8 Adam moments (the state must come
    from init_state(moment_dtype="int8")); no ``eps_root``, as in the
    reference.

    Each call is the root compute span ``train_step`` (attr ``tokens``)
    over its phases ``forward_backward`` (the microbatches' losses and
    gradients) and ``optimizer`` (the clip and the update), while a
    profiler trace is being taken; the spans of the blocks stay silent
    inside a step.  Gradient compression falls between the phases."""
    adt = getattr(torch, accum_dtype)

    def grads_of(params, batch):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss_fn(batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def split_micro(batch):
        def sp(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            return split_rows(x, microbatches)
        split = {k: sp(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in split.items()}
                for i in range(microbatches)]

    def train_step(state, batch):
        tokens = batch["tokens"]
        with compute_span("train_step", "tokens", tokens.numel(),
                          device=tokens.device):
            return step(state, batch)

    def step(state, batch):
        params = state["params"]
        with compute_span("forward_backward", leaf=True):
            if microbatches > 1:
                device = next(iter(params.values())).device
                gsum = {k: zeros_as(p, adt) for k, p in params.items()}
                lsum = torch.zeros((), dtype=adt, device=device)
                nsum = torch.zeros((), dtype=adt, device=device)
                for mb in split_micro(batch):
                    loss, _, grads = grads_of(params, mb)
                    # weight each microbatch by its valid-token count: the
                    # model loss is a mean over valid (label >= 0) tokens,
                    # so an unweighted mean-of-means diverges from the
                    # full-batch gradient whenever microbatches carry
                    # unequal valid counts.
                    if "labels" in mb:
                        n = torch.clamp((mb["labels"] >= 0).sum(),
                                        min=1).to(adt)
                    else:
                        n = torch.ones((), dtype=adt, device=device)
                    for k, g in grads.items():
                        gsum[k] += g.to(adt) * n
                    lsum = lsum + loss * n
                    nsum = nsum + n
                    del grads
                grads = {k: g / nsum for k, g in gsum.items()}
                loss = lsum / nsum
                metrics = {"xent": loss,
                           "aux": torch.zeros((), device=device)}
            else:
                loss, metrics, grads = grads_of(params, batch)

        if compress_grads:
            grads, new_res = _compress(grads, state["residuals"])
        with compute_span("optimizer", leaf=True):
            if q8_moments:
                _, new_opt, opt_metrics = q8nd_adamw_update(
                    params, grads, state["opt"], lr=lr,
                    weight_decay=weight_decay, max_grad_norm=max_grad_norm)
            else:
                _, new_opt, opt_metrics = adamw_update(
                    params, grads, state["opt"], lr=lr, eps_root=EPS_ROOT,
                    weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        state["opt"] = new_opt
        if compress_grads:
            state["residuals"] = new_res
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return state, metrics

    return train_step


def make_eval_step(model: LanguageModel) -> Callable:
    """eval_step(batch) -> dict(metrics, loss=loss), without gradients."""
    @torch.no_grad()
    def eval_step(batch):
        loss, metrics = model.loss_fn(batch)
        return dict(metrics, loss=loss)
    return eval_step
