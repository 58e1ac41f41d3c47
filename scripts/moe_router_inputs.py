#!/usr/bin/env python3
"""The first MoE layer's router input of the served qwen3-moe-235b-a22b and
deepseek-v3-671b prefills on one NVIDIA Hopper card, saved so that the JAX
reference's routing can be run on the same input on a CPU
(``tests/moe_route_witness.py``).

Each model is built as ``chip_smoke.py``'s prefill phase serves it (full
width, ``chip_smoke.PREFILL``'s depth cut and prompt length, bf16, weights
from seed 0, the prompt from seed 1) and serves one request through
``train.serve_step.make_prefill``; the first MoE layer's input (T, d) and
its fp32 ``w_router`` are kept.  Per model it prints:

- the assignments ``models.moe.route`` drops on the whole input (the first
  entry of ``chip_smoke.py``'s ``dropped_per_layer`` for the bf16
  request);
- the same on the input's first ``WITNESS_TOKENS`` rows (T = 2048), routed
  alone: the rows that are saved;
- how alike the tokens are: the mean cosine of each router input to their
  mean, beside the same for the token embeddings.

and writes ``<out_dir>/<arch>.pt`` with those rows (bf16), the router, the
card's experts and keep mask on them, and the counts.  The rows are a cut of
the prompt because the whole of qwen3-moe's input is 64 MiB.

    python3 scripts/moe_router_inputs.py <out_dir>
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from chip_smoke import DSV3, PREFILL, QWEN3, SEED  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.train.serve_step import make_prefill  # noqa: E402

WITNESS_TOKENS = 2048


def mean_cosine_to_mean(x) -> float:
    x = x.float()
    unit = torch.nn.functional.normalize(x, dim=-1)
    centre = torch.nn.functional.normalize(x.mean(dim=0), dim=0)
    return (unit @ centre).mean().item()


def first_router_input(arch: str):
    """(config, router input (T, d) bf16, the layer's MoE parameters, the
    token embeddings (T, d)) of the first MoE layer of ``arch``'s served
    prefill."""
    seq, served_cut, _ = PREFILL[arch]
    cfg = get_config(arch).replace(use_flash_kernel=True, **served_cut)
    model = build(cfg, "cuda").init(generator(SEED, "cuda"))
    tokens = torch.randint(0, cfg.vocab, (1, seq),
                           generator=generator(SEED + 1, "cuda"),
                           device="cuda")
    seen = []
    real = moe_mod.moe_apply

    def keeping(p, x, cfg):
        if not seen:
            seen.append((x.reshape(-1, x.shape[-1]).clone(), p))
        return real(p, x, cfg)
    moe_mod.moe_apply = keeping
    try:
        make_prefill(model)(tokens)
    finally:
        moe_mod.moe_apply = real
    x, p = seen[0]
    return cfg, x, p, model._embed(tokens)[0]


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.strip().splitlines()[-1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(sys.argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    for arch in (QWEN3, DSV3):
        cfg, x, p, embeds = first_router_input(arch)
        cut = x[:WITNESS_TOKENS]
        r = moe_mod.route(p, cut, cfg)
        fields = {
            "arch": arch, "tokens": x.shape[0],
            "dropped": int((~moe_mod.route(p, x, cfg).keep).sum()),
            "cut_tokens": cut.shape[0], "cut_cap": r.cap,
            "cut_dropped": int((~r.keep).sum()),
            "router_input_cos_to_mean": round(mean_cosine_to_mean(x), 4),
            "embedding_cos_to_mean": round(mean_cosine_to_mean(embeds), 4)}
        print("[router_inputs] " + " ".join(f"{k}={v}"
                                            for k, v in fields.items()),
              flush=True)
        torch.save({**fields, "x": cut.cpu(),
                    "w_router": p.w_router.detach().cpu(),
                    "experts": r.experts.cpu(), "keep": r.keep.cpu()},
                   out_dir / f"{arch}.pt")
        del x, p, embeds, cut, r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
