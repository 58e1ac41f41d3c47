"""End-to-end training driver example: train a ~100M-parameter LM with the
full framework stack (deterministic data pipeline, WSD/cosine schedule,
grad clipping, async checkpointing, exact resume), on the CUDA card.

The ``100m`` preset is the run this example exists for on the card; the
``cpu-small`` preset (the default, as in the reference) is host-sized and
runs anywhere with ``--device cpu``:

    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu   # cpu-small

The port's copy of ``examples/train_lm.py``: the same presets, registered
with ``repro_torch.configs.registry`` and trained through
``repro_torch.launch.train``.
"""
import argparse
import sys
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_mod

PRESETS = {
    # ~8M params: finishes on a CPU in a few minutes
    "cpu-small": dict(
        cfg=ModelConfig(name="lm-cpu-small", family="dense", n_layers=4,
                        d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                        vocab=4096, tie_embeddings=True),
        steps=60, batch=8, seq=128, lr=1e-3),
    # ~124M params (GPT2-small-ish): the assignment's "~100M for a few
    # hundred steps" target shape
    "100m": dict(
        cfg=ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                        vocab=32768, tie_embeddings=True),
        steps=300, batch=16, seq=512, lr=6e-4),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu-small", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the host)")
    args = ap.parse_args(argv)
    preset = PRESETS[args.preset]
    cfg = preset["cfg"]
    steps = args.steps or preset["steps"]
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")

    print(f"[train_lm] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{steps} steps, ckpts -> {ckpt_dir}")

    # drive through the production trainer with a custom config
    import repro_torch.configs.registry as registry

    # register the preset as a selectable arch on the fly
    class _Mod:
        CONFIG = cfg
        SMOKE = cfg
    registry._MODULES[cfg.name] = cfg.name
    sys.modules[f"repro_torch.configs.{cfg.name}"] = _Mod

    out = train_mod.train(cfg.name, smoke=True, steps=steps,
                          batch=preset["batch"], seq=preset["seq"],
                          lr=preset["lr"], ckpt_dir=ckpt_dir,
                          ckpt_every=max(steps // 4, 10), log_every=10,
                          device=args.device)
    print(f"[train_lm] loss {out['losses'][0]:.3f} -> "
          f"{out['final_loss']:.3f} over {len(out['losses'])} steps")
    print(f"[train_lm] resume test: re-invoking trainer picks up the "
          f"checkpoint in {ckpt_dir}")


if __name__ == "__main__":
    main()
