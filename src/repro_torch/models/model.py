"""Language model: a stack of block groups following ``cfg.pattern``, with
forward logits, the training loss, prefill and one-token decode.
Counterpart of ``repro/models/model.py`` for the dense and SSM (mamba2)
families.

The reference stores each parameter STACKED over groups and runs them with
``lax.scan``; here each group is its own module and a Python loop runs them
(``models/convert.py`` maps the stacked layout onto this one).  As in the
reference, ``cfg.remat`` wraps each group's forward when gradients are
recorded: ``"full"`` keeps only the group's input and recomputes the rest
in the backward pass, ``"block"`` also keeps the outputs of the weight
products (``aten.mm``; the reference's ``dots_with_no_batch_dims_saveable``)
and recomputes attention's batched products and the elementwise work.

Parameters are made with ``requires_grad=False``; ``train.train_step
.init_state`` turns gradients on, and serving runs under
``torch.inference_mode()``.  The reference's ``prefix`` (dense-first MoE),
``encoder`` and ``mtp`` parts raise until their families are ported
(ROADMAP.md, Queue A); until then the ``memory_embeds`` argument those
families feed is left out of the signatures.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .blocks import make_block
from .layers import dtype_of, embed_init, empty_param, pdtype_of, rmsnorm


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        for field, value, item in (
                ("first_dense", cfg.first_dense, "MoE / MLA families"),
                ("enc_layers", cfg.enc_layers, "encoder / cross-attention"),
                ("mtp_depth", cfg.mtp_depth, "MoE / MLA families")):
            if value > 0:
                raise NotImplementedError(
                    f"{cfg.name}: {field}={value} is not ported yet "
                    f"(ROADMAP.md Queue A: {item})")
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_embed = empty_param((cfg.vocab, cfg.d_model), cfg, dev)
        self.final_norm = empty_param((cfg.d_model,), cfg, dev)
        self.groups = nn.ModuleList(
            nn.ModuleDict({f"b{i}": make_block(kind, cfg, dev)
                           for i, kind in enumerate(cfg.pattern)})
            for _ in range(cfg.n_groups))
        if not cfg.tie_embeddings:
            self.lm_head = empty_param((cfg.d_model, cfg.vocab), cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LanguageModel":
        """Fill every parameter from ``generator`` (on the model's device):
        the reference's distributions, not its random numbers."""
        cfg = self.cfg
        pd = pdtype_of(cfg)
        self.tok_embed.copy_(embed_init(generator, cfg.vocab, cfg.d_model,
                                        pd))
        self.final_norm.fill_(1.0)
        for group in self.groups:
            for block in group.values():
                block.init(generator, cfg)
        if not cfg.tie_embeddings:
            self.lm_head.copy_((torch.randn(
                (cfg.d_model, cfg.vocab), generator=generator,
                device=generator.device) * 0.02).to(pd))
        return self

    # -------------------------------------------------------------- forward
    def _embed(self, tokens):
        return nn.functional.embedding(tokens, self.tok_embed).to(
            dtype_of(self.cfg))

    def _logits(self, x):
        cfg = self.cfg
        head = self.tok_embed.T if cfg.tie_embeddings else self.lm_head
        return (x @ head.to(dtype_of(cfg))) * cfg.logit_scale

    def _group_apply(self, group: nn.ModuleDict, x):
        for block in group.values():
            x = block(x, self.cfg)
        return x

    def _run_groups(self, x):
        remat = self.cfg.remat
        if remat not in ("none", *_REMAT_CONTEXTS):
            raise ValueError(f"remat={remat!r}: one of none, block, full")
        for group in self.groups:
            if remat == "none" or not torch.is_grad_enabled():
                x = self._group_apply(group, x)
            else:
                x = ckpt.checkpoint(self._group_apply, group, x,
                                    use_reentrant=False,
                                    context_fn=_REMAT_CONTEXTS[remat])
        return x

    def forward(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V), aux_loss scalar)."""
        cfg = self.cfg
        x = self._run_groups(self._embed(tokens))
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self._logits(x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)

    # ----------------------------------------------------------------- loss
    def loss_fn(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """batch: tokens (B,S), labels (B,S) (-100 = ignore) -> (loss,
        {"xent", "aux"}): the mean token cross entropy over valid labels
        (label >= 0), in fp32, plus the blocks' aux loss."""
        logits, aux = self.forward(batch["tokens"])
        labels = batch["labels"]
        valid = labels >= 0
        safe = torch.where(valid, labels, 0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        denom = torch.clamp(valid.sum(), min=1)
        xent = torch.where(valid, nll, 0.0).sum() / denom
        return xent + aux, {"xent": xent, "aux": aux}

    # --------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> Dict:
        """{"groups": [per group {"b<i>": block cache}]} on the model's
        device."""
        return {"groups": [
            {name: block.init_cache(self.cfg, batch, max_len, self.device)
             for name, block in group.items()}
            for group in self.groups]}

    def decode_step(self, cache: Dict, tokens, pos: int
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1); pos: int -> (logits (B, V), cache).  The cache is
        updated IN PLACE (the reference returns a new one)."""
        cfg = self.cfg
        x = self._embed(tokens)
        for group, gcache in zip(self.groups, cache["groups"]):
            for name, block in group.items():
                x, gcache[name] = block.decode(x, gcache[name], pos, cfg)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self._logits(x)[:, 0, :], cache

    def prefill(self, tokens, cache: Dict):
        """Sequential prefill through decode_step (exactness over speed;
        ``train.serve_step.make_prefill`` runs ``forward`` instead)."""
        logits = torch.zeros((tokens.shape[0], self.cfg.vocab),
                             dtype=torch.float32, device=tokens.device)
        for t in range(tokens.shape[1]):
            logits, cache = self.decode_step(cache, tokens[:, t:t + 1], t)
        return logits, cache

    # ----------------------------------------------------------- analytics
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _keep_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="block"``: keep what a weight
    product (``x @ W``, dispatched as ``aten.mm``) returns, recompute the
    rest."""
    if op == torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXTS = {
    "full": ckpt.noop_context_fn,
    "block": functools.partial(ckpt.create_selective_checkpoint_contexts,
                               _keep_weight_products),
}


def build(cfg: ModelConfig, device: DeviceLike = None) -> LanguageModel:
    return LanguageModel(cfg, device)
