"""Whole steps of the port as DTensor programs, on real values: every
parameter placed by ``param_specs`` (the FSDP-split ones gathered before
use, as ``launch/dryrun.py`` reads them), the batch by ``batch_specs_tree``
and the decode cache by ``cache_specs_tree``, on a (2 x 2) gloo mesh of CPU
ranks (``tests/torch_sharded_ranks.py``).  Each is held against the same
step on one device: the logits, the loss and every gradient, one train
step's loss and parameters, and two decode steps' logits and the cache
slots they write.  This is the code the dry run traces on meta tensors
(``per_shard`` forward and gradients, ``set_slot``, ``split_rows``,
``whole_units``, the RG-LRU gates' channel ranges, the MoE and sharded-SSD
regions entered from DTensors), here with numbers.

Tolerance: the sharded tests' atol 2e-5 / rtol 2e-4 (fp32), everywhere.
The MoE's capacity is E/k, so no assignment drops on either side.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train.serve_step import make_serve_step  # noqa: E402
from repro_torch.train.train_step import init_state, make_train_step  # noqa: E402,E501

import torch_sharded_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 240.0
TOL = {"atol": 2e-5, "rtol": 2e-4}
B, S, MAX_LEN, LR = 4, 16, 16, 1e-3
DECODE_POS = (5, 11)          # a slot in each model rank's half of the cache
# name -> (arch, config overrides, microbatches of the train step)
MODELS = {
    "danube": ("h2o-danube-1.8b", {}, 2),
    "rg": ("recurrentgemma-9b", {}, 1),
    "qwen3moe": ("qwen3-moe-235b-a22b", {}, 1),
    "mamba2": ("mamba2-1.3b", {}, 1),
    "mamba2_shard_map": ("mamba2-1.3b", {"ssd_shard_map": True}, 1),
}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _case(name, rng):
    arch, overrides, micro = MODELS[name]
    cfg = get_config(arch, smoke=True).replace(use_flash_kernel=False,
                                               **overrides)
    model = build(cfg, device="cpu")
    model.init(generator(0, "cpu"))
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int64)
    labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int64)
    labels[0, :3] = -1                    # a few masked positions
    cache = _map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.5),
        model.init_cache(B, MAX_LEN))
    decode = [(pos, {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, 1), dtype=np.int64))})
        for pos in DECODE_POS]
    return {"arch": arch, "overrides": dict(overrides, use_flash_kernel=False),
            "microbatches": micro, "lr": LR,
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "batch": {"tokens": torch.from_numpy(tokens),
                      "labels": torch.from_numpy(labels)},
            "cache": cache, "decode": decode}


def _one_device(case):
    """The same steps on one device, no mesh."""
    cfg = get_config(case["arch"], smoke=True).replace(**case["overrides"])
    model = build(cfg, device="cpu")
    model.load_state_dict(case["params"])
    out = {}
    with torch.no_grad():
        out["logits"] = model.forward(case["batch"]["tokens"])[0]
    state = init_state(model)
    loss, _ = model.loss_fn(case["batch"])
    loss.backward()
    out["loss"] = loss.detach()
    out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    step = make_train_step(model, lr=case["lr"],
                           microbatches=case["microbatches"])
    state, metrics = step(state, case["batch"])
    out["step_loss"] = metrics["loss"]
    out["params"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    with torch.inference_mode():
        model = build(cfg, device="cpu")
        model.load_state_dict(case["params"])
        cache = _map(torch.clone, case["cache"])
        serve = make_serve_step(model)
        out["decode"] = []
        for pos, tokens in case["decode"]:
            logits, cache = serve(cache, tokens["tokens"], pos)
            out["decode"].append(logits)
        out["cache"] = cache
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({name: inputs}, {name: one-device outputs}, [each rank's {name:
    outputs}])."""
    rng = np.random.default_rng(0)
    cases = {name: _case(name, rng) for name in MODELS}
    want = {name: _one_device(case) for name, case in cases.items()}
    case_dir = tmp_path_factory.mktemp("dtensor_steps")
    torch.save({"steps": cases}, case_dir / "inputs.pt")
    outs = ranks.spawn(4, str(case_dir), (2, 2), timeout=SPAWN_TIMEOUT)
    return cases, want, [o["steps"] for o in outs]


def _close(got, want, what):
    assert got.shape == want.shape, what
    torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_loss_and_grads(runs, name):
    cases, want, outs = runs
    w = want[name]
    for r, out in enumerate(outs):
        got = out[name]
        _close(got["logits"], w["logits"], f"rank {r} logits")
        _close(got["loss"], w["loss"], f"rank {r} loss")
        assert set(got["grads"]) == set(w["grads"])
        for n, g in w["grads"].items():
            _close(got["grads"][n], g, f"rank {r} grad {n}")


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step(runs, name):
    cases, want, outs = runs
    w = want[name]
    for r, out in enumerate(outs):
        got = out[name]
        _close(got["step_loss"], w["step_loss"], f"rank {r} step loss")
        for n, p in w["params"].items():
            _close(got["params"][n], p, f"rank {r} param {n}")
    # the step moved the parameters
    before = cases[name]["params"]
    assert all(not torch.equal(p, before[n])
               for n, p in w["params"].items() if w["grads"][n].any())


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_steps(runs, name):
    cases, want, outs = runs
    w = want[name]
    flat_want, flat_before = [], []
    _map(flat_want.append, w["cache"])
    _map(flat_before.append, cases[name]["cache"])
    # each step wrote its slots
    assert any(not torch.equal(c, b) for c, b in zip(flat_want, flat_before))
    for r, out in enumerate(outs):
        got = out[name]
        for i, (g, l) in enumerate(zip(got["decode"], w["decode"])):
            _close(g, l, f"rank {r} decode {i} logits")
        flat_got = []
        _map(flat_got.append, got["cache"])
        assert len(flat_got) == len(flat_want)
        for i, (g, c) in enumerate(zip(flat_got, flat_want)):
            _close(g, c, f"rank {r} cache leaf {i}")
