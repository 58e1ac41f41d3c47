"""One run of one cell: set-up, the measured window, the traced reduction,
and the comparison with the plain reference that decides ``correct``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything it
needs is found by name: its configuration file (``configs[].file``), its
traffic mix (``portbench/traffic/<traffic>.json``), its limits
(``portbench/limits/<workload>.json``) and each per-layer metric's reader
(``portbench/metrics/<metric>.py``, a ``read(trace)`` that returns a number
or None) and, where there is one, the configuration's own module of
equations and work counts (``portbench/references/<config>.py``;
``yardstick``).  An end-to-end metric named ``<quantity>.<tag>`` reports
the run's ``<quantity>`` under a bound of its own, for the cells it lists;
a per-layer metric so named, with no reader of its own, is read by
``<quantity>``'s reader (``reader_path``).
The program under test is ``repro_torch``; this module imports it inside
the functions that run it, never at import.
"""
from __future__ import annotations

import ast
import functools
import gc
import importlib.util
import json
import math
import pkgutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import counts, reference, tracing
from .traffic import PrefillTraffic, TrainBatches, check_sample, seed_words

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 4.0        # the traced part of a --trace 1 window
# the work counts a configuration's module may give over ``counts.py``'s
COUNTS = ("prefill_flops", "train_flops", "attention_layers",
          "attention_calls")


# ------------------------------------------------------------------ the cell

def load_cell(workload: str, root: Path = ROOT,
              overrides: Optional[dict] = None) -> SimpleNamespace:
    """The cell's entries and files; its ``model`` is the configuration
    file's model with the mix's program settings (and ``overrides``) over
    it, as the program runs it."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_file = json.loads((root / config["file"]).read_text())
    here = root / BENCH_DIR
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits_path = here / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) \
        if limits_path.is_file() else {}
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in e2e_names]
    model = {**cfg_file["model"], **mix.get("program", {}),
             **(overrides or {})}
    return SimpleNamespace(name=workload, chips=cell["chips"],
                           model=model, mix=mix, limits=limits,
                           end_to_end=e2e, per_layer=per_layer,
                           metrics_dir=here / "metrics",
                           own=here / "references" / f"{cell['config']}.py")


def model_config(cell):
    """The port's ``ModelConfig`` of the cell's model."""
    from repro_torch.configs.base import ModelConfig
    fields = dict(cell.model, pattern=tuple(cell.model["pattern"]))
    return ModelConfig(**fields)


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metrics_dir: Path, name: str) -> Path:
    """A per-layer metric's reader: ``metrics/<name>.py``, or, for a name
    ``<quantity>.<tag>`` with no file of its own, ``<quantity>``'s (the same
    reading, moving the end-to-end metric of the cells the entry lists)."""
    path = metrics_dir / f"{name}.py"
    quantity, dot, _ = name.rpartition(".")
    return path if path.is_file() or not dot else \
        metrics_dir / f"{quantity}.py"


def reader(cell, name: str):
    return _load(reader_path(cell.metrics_dir, name),
                 "portbench_metric_").read


def own_module(path: Path):
    """A configuration's module, loaded by path.  It is part of the
    yardstick, so it may import nothing of the program (nor jax or the
    reference package): neither in its source nor among its names once
    loaded."""
    tree = ast.parse(path.read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    mod = _load(path, "portbench_reference_")
    names |= {getattr(v, "__module__", None) or getattr(v, "__name__", "")
              for v in vars(mod).values()
              if isinstance(v, ModuleType) or callable(v)}
    bad = sorted(n for n in names if n and n.split(".")[0] in
                 FORBIDDEN + ("repro_torch",))
    if bad:
        raise ValueError(f"{path.name} imports {bad}: a reference module "
                         f"takes nothing of the program")
    return mod


def yardstick(cell) -> SimpleNamespace:
    """The cell's reference equations, weights and work counts:
    ``reference.py``'s and ``counts.py``'s, with whatever the
    configuration's own module (``references/<config>.py``, where there is
    one) gives over them: ``KINDS`` (its block kinds' leaves, added to the
    default ``param_spec``, or replacing a default kind's), a ``Reference``
    class, and the counts ``COUNTS``: ``prefill_flops(m, s)``,
    ``train_flops(m, b, s)``, ``attention_layers(m)``,
    ``attention_calls(m, s)``."""
    own = own_module(cell.own) if cell.own.is_file() else None

    def get(name, default):
        return getattr(own, name, default)
    spec = functools.partial(reference.param_spec, kinds=get("KINDS", None))
    ref_class = get("Reference", reference.Reference)
    return SimpleNamespace(
        own=own, param_spec=spec,
        make_weights=lambda m, seed, dev: reference.make_weights(
            m, seed, dev, spec(m)),
        Reference=ref_class,
        follow_training=functools.partial(reference.follow_training,
                                          reference=ref_class),
        counts=SimpleNamespace(**{name: get(name, getattr(counts, name))
                                  for name in COUNTS}))


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ----------------------------------------------------------------- the card

class Card:
    """What a run reads of its device; on the CPU (tests only) memory
    reads 0 and there is nothing to wait for."""

    def __init__(self, device: str):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def info(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(
            self.dev), "count": 1}
        try:
            q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader,nounits", "-i",
                                str(self.dev.index or 0)],
                               capture_output=True, text=True, timeout=30)
            out["power_limit_w"] = float(q.stdout.split()[0])
        except (OSError, ValueError, IndexError,
                subprocess.TimeoutExpired):
            out["power_limit_w"] = None
        return out


class Counters:
    """Every kernel module's ``launches`` counter of the port, read
    together."""

    def __init__(self):
        import repro_torch.kernels as kernels
        self.mods = {
            info.name: importlib.import_module(
                f"repro_torch.kernels.{info.name}.kernel")
            for info in pkgutil.iter_modules(kernels.__path__)
            if info.ispkg}

    def read(self) -> Dict[str, int]:
        return {k: int(getattr(m, "launches", 0))
                for k, m in self.mods.items()}

    def since(self, before: Dict[str, int]) -> Dict[str, int]:
        return {k: v - before[k] for k, v in self.read().items()}


def load_weights(model, weights: Dict[str, torch.Tensor]):
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(
            f"the program's parameters and the benchmark's weights differ: "
            f"only the program's {sorted(set(params) - set(weights))[:5]}, "
            f"only the benchmark's {sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if p.shape != w.shape or p.dtype != w.dtype:
                raise RuntimeError(f"{name}: the program holds {p.dtype} "
                                   f"{tuple(p.shape)}, the benchmark made "
                                   f"{w.dtype} {tuple(w.shape)}")
            p.copy_(w)


class Tracer:
    """The profiler over the first whole cycles (prefill) or steps
    (training) of a window that pass ``TRACE_SECONDS``; off unless
    ``--trace 1``."""

    def __init__(self, on: bool, card: Card):
        self.on, self.card = on, card
        self.prof = self.span = None
        self.done = not on
        self.counters = Counters() if on else None

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self):
        if self.done:
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        # On the card only the device's work and the CUDA runtime calls are
        # traced: recording every aten op would add host time of its own to
        # the window whose idle share is read.  The window opens and closes
        # at a device synchronise, which the trace records.
        self.prof = profile(activities=[ProfilerActivity.CUDA]
                            if self.card.cuda else [ProfilerActivity.CPU])
        self.prof.start()
        self.card.sync()
        self.span = record_function(tracing.WINDOW_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        self.counters0 = self.counters.read()

    def at_boundary(self) -> bool:
        """At the end of a cycle or step: stop once the traced seconds
        have passed.  True when this call stopped the trace."""
        if not self.active or time.perf_counter() - self.t0 < TRACE_SECONDS:
            return False
        self.stop()
        return True

    def stop(self):
        self.card.sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.launches = self.counters.since(self.counters0)
        self.done = True

    def reduce(self) -> dict:
        return tracing.reduce(*tracing.raw_events(self.prof))


# --------------------------------------------------------------- the checks

def compare(readings: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number compared beside its limit (None where the cell has no
    limit for it yet, which fails)."""
    return {k: {"value": v, "limit": limits.get(k, {}).get("limit")}
            for k, v in readings.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())


def prefill_readings(got: List[torch.Tensor], tokens: List[int],
                     want: List[torch.Tensor]) -> Dict[str, float]:
    """``logit_err``: the largest ||got - want|| / ||want|| of the last
    token's logits; ``token_gap``: the widest gap by which a served token's
    logit lies below the reference's best."""
    errs, gaps = [], []
    for g, t, w in zip(got, tokens, want):
        g = g.float().to(w.device)
        errs.append(float(torch.linalg.vector_norm(g - w)
                          / torch.linalg.vector_norm(w)))
        gaps.append(float(w.max() - w[t]))
    return {"logit_err": max(errs), "token_gap": max(gaps)}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    """The worst leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in names)


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``first_loss_gap``: the first step's loss, relative (the later
    steps' losses swing with the trajectory, which amplifies rounding);
    ``grad_gap``: the worst leaf's first clipped gradient; ``change_gap``:
    the worst leaf's change over the followed steps, of the leaves whose
    reference gradient is at least a thousandth of the median leaf's (the
    others move by round-off alone)."""
    g = ref["first_grad"]
    floor = 1e-3 * statistics.median(g.values())
    keep = {k for k, v in g.items() if v >= floor}
    return {"first_loss_gap": abs(prog["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap": leaf_gap(prog["first_grad"], g),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep)}


# ------------------------------------------------------------ prefill cells

def run_prefill(cell, ys, cfg, seed, seconds, tracer, card, t_start,
                control):
    from repro_torch.models import build
    from repro_torch.train import serve_step
    model = build(cfg, card.dev)
    load_weights(model, ys.make_weights(cell.model, seed, card.dev))
    prefill = serve_step.make_prefill(model)
    traffic = PrefillTraffic(cell.mix, cfg.vocab, seed)

    def serve(ids_np):
        ids = torch.from_numpy(ids_np).to(card.dev)
        logits = prefill(ids[None])
        return logits[0], int(torch.argmax(logits[0]))

    for n in sorted(set(traffic.cycle), reverse=True):       # warm-up
        rng = np.random.default_rng(seed_words(seed, 5, n))
        serve(rng.integers(0, cfg.vocab, size=n, dtype=np.int64))
    card.sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = card.peak()
    card.reset_peak()

    served = []              # (length, ttft s, token, logits)
    traced = []              # (length, launches) of the traced requests
    tracer.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        i = len(served)
        ids_np = traffic.ids(i)
        before = tracer.counters.read() if tracer.active else None
        t_sub = time.perf_counter()
        logits, token = serve(ids_np)
        t_done = time.perf_counter()
        served.append((len(ids_np), t_done - t_sub, token, logits.clone()))
        del logits
        if before is not None:
            traced.append({"len": len(ids_np),
                           "launches": tracer.counters.since(before)})
            if len(served) % len(traffic.cycle) == 0:
                tracer.at_boundary()
        if t_done >= deadline:
            break
    window_s = t_done - t0
    window_peak = card.peak()
    if tracer.active:
        tracer.stop()

    lengths = [r[0] for r in served]
    ttfts = [r[1] for r in served]
    out = {
        "setup_s": setup_s, "window_s": window_s,
        "memory": max(setup_peak, window_peak),
        "e2e": {"prompt_tok_s": sum(lengths) / window_s,
                "ttft_p95_ms": 1e3 * statistics.quantiles(
                    ttfts, n=100, method="inclusive")[94]
                if len(ttfts) > 1 else 1e3 * ttfts[0],
                "peak_mem_gb": window_peak / 1e9},
        "attempted": len(served), "failed": 0,
    }
    if tracer.on:
        out["traced"] = {"prompts": traced,
                         "ttft_ms": [1e3 * t for t in ttfts]}
    sample = check_sample(lengths, int(cell.mix["check_requests"]), seed)
    got = [served[i][3] for i in sample]
    tokens = [served[i][2] for i in sample]
    del model, prefill, served
    card.free()

    # the reference, once the program's state is freed
    t_ref = time.perf_counter()
    w = ys.make_weights(cell.model, seed, card.dev)
    ref = ys.Reference(cell.model, w)
    want = [ref.last_logits(torch.from_numpy(traffic.ids(i)).to(card.dev))
            for i in sample]
    out["readings"] = prefill_readings(got, tokens, want)
    card.sync()
    out["ref_s"] = time.perf_counter() - t_ref
    if control:
        ctl = ys.Reference(cell.model, w, fp8=True)
        ctl_logits = [ctl.last_logits(torch.from_numpy(traffic.ids(i))
                                      .to(card.dev)) for i in sample]
        out["control"] = prefill_readings(
            ctl_logits, [int(torch.argmax(c)) for c in ctl_logits], want)
    out["checked"] = len(sample)
    return out


# ----------------------------------------------------------- training cells

def _to(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0,
               minus: Optional[Dict[str, torch.Tensor]] = None):
    with torch.no_grad():
        return {k: float(torch.linalg.vector_norm(
            t.float() - (minus[k].float() if minus else 0.0))) * scale
            for k, t in tensors.items()}


def run_train(cell, ys, cfg, seed, seconds, tracer, card, t_start,
              control):
    from repro_torch.models import build
    from repro_torch.train import train_step as ts
    mix = cell.mix
    model = build(cfg, card.dev)
    load_weights(model, ys.make_weights(cell.model, seed, card.dev))
    state = ts.init_state(model)
    step = ts.make_train_step(model, lr=mix["lr"],
                              weight_decay=mix["weight_decay"],
                              max_grad_norm=mix["max_grad_norm"])
    batches = TrainBatches(mix, cfg.vocab, seed)
    b1 = 0.9

    def run_step(k):
        batch = _to(batches.batch_at(k), card.dev)
        nonlocal state
        state, metrics = step(state, batch)
        return float(metrics["loss"])

    # the first steps, through the window's own call and feed; the check
    # reads the first gradient from the moments and the change after them
    prog = {"losses": []}
    for k in range(int(mix["check_steps"])):
        prog["losses"].append(run_step(k))
        if k == 0:
            prog["first_grad"] = leaf_norms(state["opt"]["mu"], 1 / (1 - b1))
    p0 = ys.make_weights(cell.model, seed, card.dev)
    prog["change"] = leaf_norms(state["params"], minus=p0)
    del p0          # its blocks stay cached: the window mallocs nothing
    card.sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = card.peak()
    card.reset_peak()

    tracer.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = int(mix["check_steps"])
    steps = failed = 0
    traced_steps = None
    while True:
        loss = run_step(k)
        t_done = time.perf_counter()
        k += 1
        steps += 1
        failed += not math.isfinite(loss)
        if tracer.at_boundary():
            traced_steps = steps
        if t_done >= deadline:
            break
    window_s = t_done - t0
    window_peak = card.peak()
    tokens = int(mix["batch"]) * int(mix["seq"])
    out = {"setup_s": setup_s, "window_s": window_s,
           "memory": max(setup_peak, window_peak),
           "e2e": {"train_tok_s": steps * tokens / window_s,
                   "peak_mem_gb": window_peak / 1e9},
           "attempted": steps, "failed": failed}
    if tracer.on:
        if tracer.active:
            tracer.stop()
            traced_steps = steps
        out["traced"] = {"steps": traced_steps, "batch": int(mix["batch"]),
                         "seq": int(mix["seq"])}
    del model, state, step
    card.free()

    follow = [_to(batches.batch_at(k), card.dev)
              for k in range(int(mix["check_steps"]))]
    kw = dict(lr=mix["lr"], weight_decay=mix["weight_decay"],
              max_grad_norm=mix["max_grad_norm"])
    t_ref = time.perf_counter()
    w = ys.make_weights(cell.model, seed, card.dev)
    ref = ys.follow_training(cell.model, w, follow, **kw)
    out["readings"] = train_readings(prog, ref)
    out["ref_s"] = time.perf_counter() - t_ref
    out["raw"] = {"program": prog, "reference": ref}
    if control:
        card.free()
        ctl = ys.follow_training(cell.model, w, follow, fp8=True, **kw)
        out["control"] = train_readings(ctl, ref)
        out["raw"]["control"] = ctl
    out["checked"] = len(follow)
    return out


# ---------------------------------------------------------------- one run

RUNS = {"prefill": run_prefill, "train": run_train}


def run_cell(workload: str, *, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device: str = "cuda",
             t_start: Optional[float] = None, control: bool = False,
             overrides: Optional[dict] = None) -> dict:
    """One run; returns the result line's object and, under ``_run``, the
    raw readings (``run.py`` drops them)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, root, overrides)
    ys = yardstick(cell)
    card = Card(device)
    tracer = Tracer(trace, card)
    run = RUNS[cell.mix["kind"]](cell, ys, model_config(cell), seed,
                                 seconds, tracer, card, t_start, control)
    e2e = dict(run["e2e"], setup_s=run["setup_s"])
    device = dict(card.info(), memory_peak_bytes=run["memory"])
    if trace:
        reduced = tracer.reduce()
        traced = SimpleNamespace(
            model=cell.model, mix=cell.mix, counts=ys.counts,
            launches=tracer.launches,
            window_s=reduced["window_s"], busy_s=reduced["busy_s"],
            kernels=reduced["kernels"],
            kernel_seconds=lambda part: sum(
                v for k, v in reduced["kernels"].items() if part in k),
            prompts=run["traced"].get("prompts", []),
            ttft_ms=run["traced"].get("ttft_ms", []),
            steps=run["traced"].get("steps", 0),
            batch=run["traced"].get("batch", 0),
            seq=run["traced"].get("seq", 0))
        metrics = {}
        for m in cell.per_layer:
            value = reader(cell, m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    else:
        metrics = {m["name"]: {"value": e2e[m["name"].partition(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = compare(run["readings"], cell.limits)
    result = {"correct": passed(checks) and run["failed"] == 0,
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = reduced["breakdown"]
    result["checks"] = checks
    result["_run"] = dict(
        {k: run.get(k) for k in ("readings", "control", "checked",
                                 "window_s", "ref_s", "raw")}, e2e=e2e)
    return result
