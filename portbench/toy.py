"""Toy cells for the CPU tests: a benchmark root in a directory of its own,
holding a ``BENCHMARK.json`` and, under ``portbench/``, a configuration,
a mix, a limits file and a per-layer metric for each toy cell, and nothing
else.  It shows that a cell is added by adding files and entries, and that
a configuration whose block kind the default equations do not know
(``toy-moe``) brings them as one more file, ``references/toy-moe.py``.
``write_real_with_module`` adds that configuration's cell to a copy of the
real benchmark, as a later PR would add one."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

DANUBE = {"name": "toy-danube", "family": "dense", "n_layers": 2,
          "d_model": 64, "n_heads": 4, "n_kv_heads": 1, "head_dim": 16,
          "d_ff": 160, "vocab": 128, "window": 100,
          "pattern": ["local_attn"], "rope_theta": 10000.0,
          "norm_eps": 1e-6, "tie_embeddings": False, "dtype": "float32",
          "param_dtype": "float32", "remat": "none", "attn_chunk": 0}
MAMBA = {"name": "toy-mamba", "family": "ssm", "n_layers": 2,
         "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
         "vocab": 128, "pattern": ["ssm"], "ssm_state": 16,
         "ssm_headdim": 16, "ssm_expand": 2, "ssm_chunk": 16,
         "conv_width": 4, "norm_eps": 1e-6, "tie_embeddings": True,
         "dtype": "float32", "param_dtype": "float32", "remat": "none"}
# the port's moe block behind one dense prefix block; a capacity factor of
# n_experts / top_k gives every expert a slot for every token: none drops
MOE = {"name": "toy-moe", "family": "moe", "n_layers": 3, "first_dense": 1,
       "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
       "d_ff": 96, "vocab": 128, "pattern": ["moe"], "n_experts": 8,
       "top_k": 2, "n_shared_experts": 1, "d_expert": 32,
       "capacity_factor": 4.0, "rope_theta": 10000.0, "norm_eps": 1e-6,
       "tie_embeddings": False, "dtype": "float32",
       "param_dtype": "float32", "remat": "none", "attn_chunk": 0}
MODELS = (DANUBE, MAMBA, MOE)
REFERENCES = {"toy-moe": "toy_moe"}      # config -> its module here
MIXES = {
    "toy-prefill": {"kind": "prefill", "program": {"use_flash_kernel": True},
                    "lengths": {"list": [48, 96], "always": [128]},
                    "check_requests": 3},
    "toy-train": {"kind": "train", "program": {"use_flash_kernel": False},
                  "batch": 2, "seq": 32, "lr": 1e-3, "weight_decay": 0.1,
                  "max_grad_norm": 1.0, "check_steps": 3},
}
# fp32 toy models read ~1e-6 against the reference on the CPU; the fp8
# control reads 1e-3 or more on every number but the toy's token gap.
PREFILL_LIMITS = {"logit_err": {"limit": 1e-4}, "token_gap": {"limit": 1e-4}}
TRAIN_LIMITS = {"first_loss_gap": {"limit": 1e-5},
                "grad_gap": {"limit": 1e-4}, "change_gap": {"limit": 1e-4}}
CELLS = {"toy-danube.toy-prefill": ("toy-danube", "toy-prefill"),
         "toy-mamba.toy-prefill": ("toy-mamba", "toy-prefill"),
         "toy-danube.toy-train": ("toy-danube", "toy-train"),
         "toy-moe.toy-prefill": ("toy-moe", "toy-prefill")}
# a per-layer metric that a later PR would add as one file and one entry
TOY_METRIC = '''def read(t):
    return float(len(t.prompts) + t.steps) or None
'''


def write_root(root: Path) -> Path:
    """The toy benchmark under ``root``; returns ``root``."""
    here = root / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics", "references"):
        (here / sub).mkdir(parents=True, exist_ok=True)
    for model in MODELS:
        (here / "configs" / f"{model['name']}.json").write_text(
            json.dumps({"model": model}))
    for config, module in REFERENCES.items():
        shutil.copy(HERE / f"{module}.py",
                    here / "references" / f"{config}.py")
    for name, mix in MIXES.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (_, mix) in CELLS.items():
        limits = TRAIN_LIMITS if mix == "toy-train" else PREFILL_LIMITS
        (here / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (here / "metrics" / "toy_units.py").write_text(TOY_METRIC)
    prefill = [c for c, (_, m) in CELLS.items() if m == "toy-prefill"]
    train = [c for c, (_, m) in CELLS.items() if m == "toy-train"]
    bench = {
        "command": ["python3", "portbench/run.py"],
        "paths": ["portbench"], "run_seconds": 1,
        "configs": [{"name": m["name"], "source": "toy",
                     "file": f"portbench/configs/{m['name']}.json",
                     "reduced": [], "why": "toy"} for m in MODELS],
        "workloads": [{"name": c, "config": cfg, "traffic": mix,
                       "chips": 1, "why": "toy"}
                      for c, (cfg, mix) in CELLS.items()],
        "end_to_end": [
            {"name": "prompt_tok_s", "unit": "tokens/s", "better": "higher",
             "bound": 0.03, "source": "host_clock", "workloads": prefill},
            {"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
             "bound": 0.03, "source": "host_clock", "workloads": prefill},
            {"name": "train_tok_s", "unit": "tokens/s", "better": "higher",
             "bound": 0.03, "source": "host_clock", "workloads": train},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "toy_units", "unit": "1", "better": "higher",
             "source": "program_counter", "layer": "toy",
             "moves": "setup_s"}],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


# the cell a later PR adds to the real benchmark in write_real_with_module,
# reporting what this real prefill cell reports
MODULE_CELL = "toy-moe.toy-prefill"
LIKE_CELL = "h2o-danube-1.8b.rag-chunks"


def write_real_with_module(root: Path) -> Path:
    """The real benchmark's ``BENCHMARK.json`` and data files under ``root``,
    with ``MODULE_CELL`` added as a later PR adds a cell whose configuration
    brings its own module: its configuration, mix, limits and module as new
    files, its entries appended, and its name appended to the ``workloads``
    of every metric that ``LIKE_CELL`` reports.  Returns ``root``."""
    here = root / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics", "references"):
        if (HERE / sub).is_dir():
            shutil.copytree(HERE / sub, here / sub)
        (here / sub).mkdir(parents=True, exist_ok=True)
    config, mix = CELLS[MODULE_CELL]
    (here / "configs" / f"{config}.json").write_text(
        json.dumps({"model": MOE}))
    (here / "traffic" / f"{mix}.json").write_text(json.dumps(MIXES[mix]))
    (here / "limits" / f"{MODULE_CELL}.json").write_text(
        json.dumps(PREFILL_LIMITS))
    shutil.copy(HERE / f"{REFERENCES[config]}.py",
                here / "references" / f"{config}.py")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config, "source": "toy",
                             "file": f"portbench/configs/{config}.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": MODULE_CELL, "config": config,
                               "traffic": mix, "chips": 1, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LIKE_CELL in m.get("workloads", []):
            m["workloads"].append(MODULE_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
