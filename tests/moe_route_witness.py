"""The JAX reference's MoE routing on router inputs saved from the card by
``scripts/moe_router_inputs.py``: whether the reference drops the
assignments the port drops, on the same input and the same router weights.

The reference does not return its routing, so it is read from the output of
its one-device dispatch ``_moe_apply_gspmd`` (``repro/models/moe.py``) with
probe experts in place of the model's: one hidden unit (``we_g`` = ``we_u``
= a random vector w, so h = silu(x.w) * (x.w) > 0) and ``we_d[e]`` the unit
vector of column e (d >= E).  Token t's output is then nonzero in column e
exactly when t's assignment to expert e was kept: the kept set, as the
reference's own scatter, capacity and gather-back computed it.  The router
is the model's, so the routing is that of the served model.

    PYTHONPATH=src python tests/moe_route_witness.py <dir of .pt files>

Prints, per saved model, the assignments dropped on the card (the port's
``moe.route``), by the port on this CPU, and by the reference, and the
assignments on which the reference and the card differ.
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import moe


def reference_kept(x: np.ndarray, w_router: np.ndarray, ref_cfg,
                   seed: int = 0) -> np.ndarray:
    """(T, E) bool: the assignments the reference keeps for tokens ``x``
    (T, d) under ``w_router`` (d, E)."""
    t, d = x.shape
    e = w_router.shape[1]
    if d < e:
        raise ValueError(f"the probe needs d >= E, got d={d}, E={e}")
    w = np.random.default_rng(seed).standard_normal(d).astype(np.float32)
    w /= np.sqrt(d)
    probe = np.broadcast_to(w[None, :, None], (e, d, 1))
    p = {"w_router": jnp.asarray(w_router, jnp.float32),
         "we_g": jnp.asarray(probe), "we_u": jnp.asarray(probe),
         "we_d": jnp.asarray(np.eye(e, d, dtype=np.float32)[:, None, :])}
    cfg = ref_cfg.replace(dtype="float32")
    out, _ = jax.jit(lambda p, x: ref_moe._moe_apply_gspmd(p, x, cfg))(
        p, jnp.asarray(x, jnp.float32)[None])
    return np.asarray(out[0, :, :e]) != 0


def port_kept(r: moe.Route, t: int, e: int) -> np.ndarray:
    """(T, E) bool: the assignments a port ``Route`` keeps."""
    kept = np.zeros((t, e), bool)
    tok = np.repeat(np.arange(t), r.experts.numel() // t)
    keep = r.keep.numpy()
    kept[tok[keep], r.experts.numpy()[keep]] = True
    return kept


def witness(path: Path) -> dict:
    saved = torch.load(path)
    arch = saved["arch"]
    x = saved["x"].float()
    w_router = saved["w_router"].float()
    t, e = x.shape[0], w_router.shape[1]
    k = get_config(arch).top_k
    card = port_kept(moe.Route(None, saved["experts"], None, saved["keep"],
                               None, saved["cut_cap"]), t, e)
    cpu = port_kept(moe.route(SimpleNamespace(w_router=w_router), x,
                              get_config(arch)), t, e)
    ref = reference_kept(x.numpy(), w_router.numpy(), ref_config(arch))
    return {"arch": arch, "tokens": t, "assignments": t * k,
            "cap": saved["cut_cap"],
            "dropped_card": t * k - int(card.sum()),
            "dropped_port_cpu": t * k - int(cpu.sum()),
            "dropped_reference": t * k - int(ref.sum()),
            "kept_differ_reference_vs_card": int((ref != card).sum()),
            "kept_differ_reference_vs_port_cpu": int((ref != cpu).sum())}


def main() -> int:
    if len(sys.argv) != 2:
        print("usage: moe_route_witness.py <dir of .pt files>",
              file=sys.stderr)
        return 2
    for path in sorted(Path(sys.argv[1]).glob("*.pt")):
        fields = witness(path)
        print("[route_witness] " + " ".join(f"{k}={v}"
                                            for k, v in fields.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
