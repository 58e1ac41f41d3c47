"""Language model: a stack of block groups following ``cfg.pattern`` (with
an optional encoder or modality memory), with forward logits, the training
loss, prefill and one-token decode.  Counterpart of
``repro/models/model.py``: the dense ``prefix`` blocks before the MoE groups
(``first_dense``), DeepSeek-V3's multi-token-prediction head (``mtp``) and
whisper's ``encoder`` (``enc_layers`` bidirectional blocks over the stub
frontend's frame embeddings) are ported with the blocks.

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
``torch.inference_mode()``.

``memory_embeds`` (B, M, d): the stub frontend's output (audio frames or
image patches), which the ``cross_attn`` blocks attend to.  An enc-dec model
runs it through its encoder first, in ``forward`` and, as in the reference,
again at every ``decode_step``.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..distributed import sharding as shd
from .blocks import AttnBlock, make_block
from .layers import dtype_of, embed_init, empty_param, pdtype_of, rmsnorm


def dense_config(cfg: ModelConfig) -> ModelConfig:
    """The config of the ``attn`` blocks a MoE model keeps beside its
    groups: the dense prefix and the MTP block."""
    return cfg.replace(pattern=("attn",))


class MTP(nn.Module):
    """DeepSeek-V3's multi-token-prediction head: ``proj`` (2d, d) over the
    normed (hidden, next-token embedding) pair, one ``attn`` ``block``, and
    the norms ``norm_h``, ``norm_e``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        self.proj = empty_param((2 * d, d), cfg, device)
        self.block = AttnBlock(dense_config(cfg), device)
        self.norm_h = empty_param((d,), cfg, device)
        self.norm_e = empty_param((d,), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        d2 = 2 * cfg.d_model
        self.proj.copy_((torch.randn((d2, cfg.d_model), generator=generator,
                                     device=generator.device)
                         * d2 ** -0.5).to(pdtype_of(cfg)))
        self.block.init(generator, dense_config(cfg))
        self.norm_h.fill_(1.0)
        self.norm_e.fill_(1.0)


class Encoder(nn.Module):
    """Whisper's encoder: ``blocks``, ``enc_layers`` bidirectional
    ``enc_attn`` blocks, and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.blocks = nn.ModuleList(make_block("enc_attn", cfg, device)
                                    for _ in range(cfg.enc_layers))
        self.final_norm = empty_param((cfg.d_model,), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        for block in self.blocks:
            block.init(generator, cfg)
        self.final_norm.fill_(1.0)


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_embed = empty_param((cfg.vocab, cfg.d_model), cfg, dev)
        self.final_norm = empty_param((cfg.d_model,), cfg, dev)
        self.groups = nn.ModuleList(
            nn.ModuleDict({f"b{i}": make_block(kind, cfg, dev)
                           for i, kind in enumerate(cfg.pattern)})
            for _ in range(cfg.n_groups))
        self.prefix = nn.ModuleList(AttnBlock(dense_config(cfg), dev)
                                    for _ in range(cfg.first_dense))
        if not cfg.tie_embeddings:
            self.lm_head = empty_param((cfg.d_model, cfg.vocab), cfg, dev)
        if cfg.mtp_depth > 0:
            self.mtp = MTP(cfg, dev)
        if cfg.enc_layers > 0:
            self.encoder = Encoder(cfg, dev)

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
        for block in self.prefix:
            block.init(generator, dense_config(cfg))
        if cfg.mtp_depth > 0:
            self.mtp.init(generator, cfg)
        if cfg.enc_layers > 0:
            self.encoder.init(generator, cfg)
        return self

    # -------------------------------------------------------------- forward
    def _embed(self, tokens):
        # under a mesh the lookup reads a whole table, as the reference's
        # partitioner gathers it ("involuntary full rematerialization")
        x = nn.functional.embedding(tokens, shd.replicated(self.tok_embed)
                                    ).to(dtype_of(self.cfg))
        return shd.constrain(x, ("batch", "seq", "embed"))

    def _logits(self, x):
        cfg = self.cfg
        head = self.tok_embed.T if cfg.tie_embeddings else self.lm_head
        logits = (x @ head.to(dtype_of(cfg))) * cfg.logit_scale
        return shd.constrain(logits, ("batch", "seq", "vocab"))

    def _group_apply(self, group: nn.ModuleDict, x, memory):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in group.values():
            x, a = block(x, self.cfg, memory=memory)
            aux = aux + a
        return x, aux

    def _run_groups(self, x, memory=None):
        """-> (x, the summed aux loss of every block)."""
        remat = self.cfg.remat
        if remat not in ("none", *_REMAT_CONTEXTS):
            raise ValueError(f"remat={remat!r}: one of none, block, full")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group in self.groups:
            if remat == "none" or not torch.is_grad_enabled():
                x, a = self._group_apply(group, x, memory)
            else:
                x, a = ckpt.checkpoint(self._group_apply, group, x, memory,
                                       use_reentrant=False,
                                       context_fn=_remat_context(remat))
            aux = aux + a
        return x, aux

    def _run_prefix(self, x):
        """The dense prefix blocks, without remat, as in the reference."""
        dense_cfg = dense_config(self.cfg)
        for block in self.prefix:
            x, _ = block(x, dense_cfg)
        return x

    def _encode(self, frame_embeds):
        """The encoder over the frame embeddings, without remat, as in the
        reference."""
        x = frame_embeds.to(dtype_of(self.cfg))
        for block in self.encoder.blocks:
            x, _ = block(x, self.cfg)
        return rmsnorm(x, self.encoder.final_norm, self.cfg.norm_eps)

    def _memory(self, memory_embeds) -> Optional[torch.Tensor]:
        """What the cross_attn blocks attend to: the encoder's output for an
        enc-dec model, else the embeddings as given (in the compute
        dtype)."""
        if self.cfg.enc_layers > 0:
            if memory_embeds is None:
                raise ValueError(f"{self.cfg.name} is an enc-dec model and "
                                 f"needs memory_embeds (frames)")
            return self._encode(memory_embeds)
        if memory_embeds is None:
            return None
        return memory_embeds.to(dtype_of(self.cfg))

    def _trunk(self, tokens, memory=None):
        """Hidden states before the final norm, and the aux loss."""
        return self._run_groups(self._run_prefix(self._embed(tokens)),
                                memory)

    def forward(self, tokens, *, memory_embeds=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V), aux_loss scalar)."""
        x, aux = self._trunk(tokens, self._memory(memory_embeds))
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), aux

    # ----------------------------------------------------------------- loss
    def loss_fn(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """batch: tokens (B,S), labels (B,S) (-100 = ignore), optional
        memory_embeds -> (loss, metrics): the mean token cross entropy over
        valid labels (label >= 0), in fp32, plus the blocks' aux loss and,
        with an MTP head, 0.3 x its loss (metrics "xent", "aux" and
        "mtp")."""
        cfg = self.cfg
        trunk = None
        memory_embeds = batch.get("memory_embeds")
        if cfg.mtp_depth > 0 and cfg.mtp_share_trunk:
            # compute the trunk once; the head and MTP both read it.  As in
            # the reference, this branch casts the memory and runs no
            # encoder (no config has both an MTP head and an encoder).
            memory = (None if memory_embeds is None
                      else memory_embeds.to(dtype_of(cfg)))
            trunk, aux = self._trunk(batch["tokens"], memory)
            logits = self._logits(rmsnorm(trunk, self.final_norm,
                                          cfg.norm_eps))
        else:
            logits, aux = self.forward(batch["tokens"],
                                       memory_embeds=memory_embeds)
        labels = batch["labels"]
        xent = _masked_xent(logits, labels, labels >= 0)
        metrics = {"xent": xent, "aux": aux}
        loss = xent + aux
        if cfg.mtp_depth > 0:
            loss = loss + 0.3 * self._mtp_loss(batch, metrics, trunk=trunk)
        return loss, metrics

    def _mtp_loss(self, batch: Dict, metrics: Dict, trunk=None):
        """DeepSeek-V3 multi-token prediction: predict t+2 from a fused
        (h_t, emb_{t+1}) stream through one extra block."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        x = self._trunk(tokens)[0] if trunk is None else trunk
        h = rmsnorm(x, self.mtp.norm_h, cfg.norm_eps)
        e_next = rmsnorm(self._embed(torch.roll(tokens, -1, dims=1)),
                         self.mtp.norm_e, cfg.norm_eps)
        fused = torch.cat([h, e_next], dim=-1) @ self.mtp.proj.to(
            dtype_of(cfg))
        fused, _ = self.mtp.block(fused, dense_config(cfg))
        mtp_labels = torch.roll(labels, -1, dims=1)
        valid = mtp_labels >= 0
        valid[:, -2:] = False
        mtp = _masked_xent(self._logits(fused), mtp_labels, valid)
        metrics["mtp"] = mtp
        return mtp

    # --------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> Dict:
        """{"groups": [per group {"b<i>": block cache}]} on the model's
        device, and "prefix": [per dense prefix block cache] when the model
        has one."""
        cache = {"groups": [
            {name: block.init_cache(self.cfg, batch, max_len, self.device)
             for name, block in group.items()}
            for group in self.groups]}
        if self.cfg.first_dense > 0:
            dense_cfg = dense_config(self.cfg)
            cache["prefix"] = [block.init_cache(dense_cfg, batch, max_len,
                                                self.device)
                               for block in self.prefix]
        return cache

    def decode_step(self, cache: Dict, tokens, pos: int, *,
                    memory_embeds=None) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1); pos: int -> (logits (B, V), cache).  The cache is
        updated IN PLACE (the reference returns a new one).  An enc-dec
        model encodes ``memory_embeds`` again at every step, as the
        reference does."""
        cfg = self.cfg
        memory = self._memory(memory_embeds)
        x = self._embed(tokens)
        dense_cfg = dense_config(cfg)
        for i, block in enumerate(self.prefix):
            x, cache["prefix"][i] = block.decode(x, cache["prefix"][i], pos,
                                                 dense_cfg)
        for group, gcache in zip(self.groups, cache["groups"]):
            for name, block in group.items():
                x, gcache[name] = block.decode(x, gcache[name], pos, cfg,
                                               memory=memory)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self._logits(x)[:, 0, :], cache

    def prefill(self, tokens, cache: Dict, *, memory_embeds=None):
        """Sequential prefill through decode_step (exactness over speed;
        ``train.serve_step.make_prefill`` runs ``forward`` instead)."""
        logits = torch.zeros((tokens.shape[0], self.cfg.vocab),
                             dtype=torch.float32, device=tokens.device)
        for t in range(tokens.shape[1]):
            logits, cache = self.decode_step(cache, tokens[:, t:t + 1], t,
                                             memory_embeds=memory_embeds)
        return logits, cache

    # ----------------------------------------------------------- analytics
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _masked_xent(logits, labels, valid):
    """Mean token cross entropy in fp32 over the ``valid`` positions (0 when
    none is).  Under a mesh each rank takes its rows' whole logits."""
    safe = torch.where(valid, labels, 0).long()
    nll = shd.per_shard(_token_nll, (logits, safe),
                        (("batch", "seq", None), ("batch", "seq")),
                        ("batch", "seq"), safe.shape)
    denom = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, nll, 0.0).sum() / denom


def _token_nll(logits, safe):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, safe[..., None])[..., 0]


def _keep_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="block"``: keep what a weight
    product (``x @ W``, dispatched as ``aten.mm``) returns, recompute the
    rest."""
    if op == torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat: str):
    """The checkpoint's context_fn for ``remat``; under a mesh its recompute
    also re-enters the mesh (``distributed.sharding.reentry``), so the
    recomputed block takes the sharded paths its forward took."""
    make = _REMAT_CONTEXTS[remat]
    again = shd.reentry()
    if again is None:
        return make

    def context_fn():
        forward_ctx, recompute_ctx = make()
        return forward_ctx, _chained(recompute_ctx, again())
    return context_fn


@contextlib.contextmanager
def _chained(first, second):
    with first, second:
        yield


_REMAT_CONTEXTS = {
    "full": ckpt.noop_context_fn,
    "block": functools.partial(ckpt.create_selective_checkpoint_contexts,
                               _keep_weight_products),
}


def build(cfg: ModelConfig, device: DeviceLike = None) -> LanguageModel:
    return LanguageModel(cfg, device)
