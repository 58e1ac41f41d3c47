"""The ranks of ``tests/test_torch_sharded.py`` and
``tests/test_torch_dtensor_step.py``: each a spawned process of a gloo
process group on the CPU, which runs the port's sharded paths (or, for a
case with ``steps``, whole DTensor steps) on its block of the inputs the
test wrote and saves what it computed for the test to hold.  Imports no
JAX (the tests hold the other side themselves).

    spawn(world, case_dir, mesh_shape, timeout) -> one dict per rank

Every rank reads ``case_dir/inputs.pt`` and writes ``case_dir/rank<r>.pt``;
the rendezvous is a FileStore in ``case_dir`` (no port).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback

import torch
from torch import distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import build, moe, ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.serve_step import make_serve_step
from repro_torch.train.train_step import init_state, make_train_step

# the layer cases' configs: MoE with a shared expert at capacity E/k (no
# drops), and mamba2's SSD dims at chunk 8
MOE_CFG = ModelConfig(name="m", family="moe", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                      pattern=("moe",), n_experts=8, top_k=2, d_expert=24,
                      n_shared_experts=1, capacity_factor=4.0)
SSD_CHUNK = 8


def spawn(world: int, case_dir: str, mesh_shape: tuple,
          timeout: float = 120.0) -> list:
    """Run ``world`` ranks on ``mesh_shape``; fail if one fails or any is
    still running after ``timeout`` seconds (it is then killed)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, case_dir, mesh_shape))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"ranks {hung} still running after {timeout} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if failed:
        errs = [open(os.path.join(case_dir, f"rank{r}.err")).read()
                for r in failed
                if os.path.exists(os.path.join(case_dir, f"rank{r}.err"))]
        raise AssertionError(f"ranks failed {failed}:\n" + "\n".join(errs))
    return [torch.load(os.path.join(case_dir, f"rank{r}.pt"))
            for r in range(world)]


def _rank(rank: int, world: int, case_dir: str, mesh_shape: tuple) -> None:
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(case_dir, 'store')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60))
        inputs = torch.load(os.path.join(case_dir, "inputs.pt"),
                            weights_only=False)
        if inputs.get("hang") and rank == 0:
            time.sleep(3600)     # never joins: its partner must not hang
        pod = mesh_shape[0] if len(mesh_shape) == 3 else 1
        mesh = make_test_mesh(model=mesh_shape[-1], pod=pod, device="cpu")
        out = {"coords": _coords(mesh)}
        if "steps" in inputs:
            out["steps"] = {name: _dtensor_steps(mesh, case)
                            for name, case in inputs["steps"].items()}
            _finish(out, case_dir, rank)
            return
        with shd.use_mesh(mesh):
            out["batch"] = _batch_case(mesh, inputs["moe"]["x"])
            out["moe"] = _moe_case(mesh, inputs["moe"])
            whole = moe.MoE(MOE_CFG, "cpu")
            whole.load_state_dict(inputs["moe"]["params"])
            out["params"] = _param_case(mesh, whole)
            try:
                moe.moe_apply(whole, inputs["moe"]["x"], MOE_CFG)
                out["whole_experts_error"] = ""
            except ValueError as e:
                out["whole_experts_error"] = str(e)
        out["production_mesh_error"] = _production_mesh_error()
        with shd.use_mesh(mesh):
            out["ssd"] = _ssd_case(mesh, inputs["ssd"])
            for name, case in inputs.get("models", {}).items():
                out[name] = _model_case(case)
        if "write_ckpt" in inputs:
            _write_ckpt(inputs["write_ckpt"], world)
        if "restore" in inputs:
            out["restore"] = _restore(mesh, inputs["restore"])
        _finish(out, case_dir, rank)
    except BaseException:
        with open(os.path.join(case_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _finish(out: dict, case_dir: str, rank: int) -> None:
    torch.save(out, os.path.join(case_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _coords(mesh) -> dict:
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def dp_index(coords: dict, shape: dict) -> int:
    """The rank's block of the batch over the DP axes ("pod" major)."""
    return coords.get("pod", 0) * shape.get("data", 1) + coords["data"]


def _rows(x, mesh):
    shape = shd.mesh_shape(mesh)
    n_dp = shape.get("pod", 1) * shape["data"]
    return x.chunk(n_dp)[dp_index(_coords(mesh), shape)].clone()


def _batch_case(mesh, x) -> dict:
    """The batch spec of ``x`` under the active rules, the rows it places
    on this rank, and the whole batch again after constrain() to
    replicated."""
    spec = shd.batch_specs_tree({"x": x})["x"]
    placed = shd.distribute(x, shd.NamedSharding(mesh, spec))
    whole = shd.constrain(placed, (None, None, None))
    return {"spec": spec, "local": placed.to_local(),
            "constrained": whole.to_local(),
            "constrained_placements": [type(p).__name__
                                       for p in whole.placements]}


def _param_case(mesh, layer) -> dict:
    """param_shardings of a MoE layer under DEFAULT_RULES: each parameter's
    spec, its local block, and the block gathered back whole."""
    out = {}
    for name, sharding in shd.param_shardings(mesh, layer).items():
        placed = shd.distribute(layer.get_parameter(name), sharding)
        out[name] = {"spec": sharding.spec, "local": placed.to_local(),
                     "whole": placed.full_tensor()}
    return out


def _production_mesh_error() -> str:
    try:
        make_production_mesh(device="cpu")
    except RuntimeError as e:
        return str(e)
    return ""


def _moe_case(mesh, case) -> dict:
    """moe_apply on this rank's rows with the experts placed over "model";
    the body's own inputs and partial output; gradients of
    sum(out * w) + aux."""
    layer = moe.MoE(MOE_CFG, "cpu")
    layer.load_state_dict(case["params"])
    shd.distribute_params(layer, moe.expert_shardings(layer, mesh))
    for p in layer.parameters():
        p.requires_grad_(True)
    x = _rows(case["x"], mesh).requires_grad_(True)
    w = _rows(case["w"], mesh)
    out, aux = moe.moe_apply(layer, x, MOE_CFG)
    ((out * w).sum() + aux).backward()

    with torch.no_grad():
        return _moe_body(mesh, layer, x, out, aux)


def _moe_body(mesh, layer, x, out, aux) -> dict:
    xt = x.detach().reshape(-1, x.shape[-1])
    r = moe.route(layer, xt, MOE_CFG)
    gates = r.gates.reshape(-1, MOE_CFG.top_k)
    ids = r.experts.reshape(-1, MOE_CFG.top_k)
    cap = moe.capacity(MOE_CFG, xt.shape[0])
    blocks = {n: getattr(layer, n).to_local().detach()
              for n in ("we_g", "we_u", "we_d")}
    partial = moe._moe_dispatch_local(
        xt, gates, ids, *blocks.values(), cap_local=cap,
        rank_id=mesh.get_local_rank("model"), dt=torch.float32)
    grads = {n: (p.grad.to_local() if isinstance(p.grad, shd.DTensor)
                 else p.grad).clone()
             for n, p in layer.named_parameters()}
    return {"out": out.detach(), "aux": aux.detach(), "x_grad": x.grad,
            "grads": grads, "body": {"xt": xt, "gates": gates, "ids": ids,
                                     "cap": cap, "partial": partial,
                                     "blocks": blocks}}


def _ssd_case(mesh, case) -> dict:
    """ssd_apply_shard_map on this rank's rows, gradients of sum(y * w),
    and the body on this rank's heads (fp32 and bf16 tiles)."""
    cfg = get_config("mamba2-1.3b", smoke=True).replace(ssm_chunk=SSD_CHUNK)
    leaves = {k: _rows(case[k], mesh).requires_grad_(True)
              for k in ("xh", "dt", "b", "c")}
    a_log = case["a_log"].clone().requires_grad_(True)
    y = ssm.ssd_apply_shard_map(
        leaves["xh"], leaves["dt"], a_log, leaves["b"], leaves["c"], cfg,
        mesh=mesh, dp_axes=shd.dp_axes_of(shd.current_rules()))
    (y * _rows(case["w"], mesh)).sum().backward()

    n = shd.mesh_shape(mesh)["model"]
    m = mesh.get_local_rank("model")
    heads = [t.detach().chunk(n, dim=dim)[m]
             for t, dim in ((leaves["xh"], 2), (leaves["dt"], 2),
                            (a_log, 0))]
    body = {"inputs": (*heads, leaves["b"].detach(), leaves["c"].detach())}
    for tile in (None, torch.bfloat16):
        body[str(tile)] = ssm._ssd_local_body(*body["inputs"],
                                              chunk=SSD_CHUNK,
                                              tile_dtype=tile)
    grads = {k: v.grad for k, v in leaves.items()}
    grads["a_log"] = a_log.grad
    return {"y": y.detach(), "grads": grads, "body": body}


def _model_case(case) -> dict:
    """A smoke model's forward from the reference's numpy weights, its MoE
    experts placed over "model"."""
    cfg = get_config(case["arch"], smoke=True).replace(**case["overrides"])
    model = params_from_jax(case["params"], cfg, device="cpu")
    if cfg.n_experts:
        shd.distribute_params(model, moe.expert_shardings(
            model, shd.active_mesh()))
    with torch.inference_mode():
        logits, aux = model.forward(case["tokens"])
    return {"logits": logits, "aux": aux}


def _write_ckpt(case, world: int) -> None:
    """A tree sharded over all ranks on a 1-D mesh, gathered and written
    by rank 0."""
    mesh1 = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    w = shd.distribute(case["tree"]["w"],
                       shd.NamedSharding(mesh1, ("data", None)))
    tree = {"w": w.full_tensor()}
    if dist.get_rank() == 0:
        ckpt.save(case["path"], tree, step=1)
    dist.barrier()


def _restore(mesh, case) -> dict:
    """Each checkpoint restored onto this mesh over "model"."""
    out = {}
    for name, path in case["paths"].items():
        sharding = shd.NamedSharding(mesh, ("model", None))
        tree, manifest = ckpt.restore(path, case["like"],
                                      shardings={"w": sharding})
        w = tree["w"]
        out[name] = {"local": w.to_local(), "full": w.full_tensor(),
                     "placements": [(type(p).__name__, getattr(p, "dim", None))
                                    for p in w.placements],
                     "step": manifest["step"]}
    return out


def _whole(t):
    return t.full_tensor() if isinstance(t, shd.DTensor) else t


def _whole_tree(tree):
    if isinstance(tree, dict):
        return {k: _whole_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_whole_tree(v) for v in tree]
    return _whole(tree)


def _placed(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _placed(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placed(v, s, mesh) for v, s in zip(tree, specs)]
    return shd.distribute(tree, shd.NamedSharding(mesh, specs))


def _dtensor_model(case, mesh):
    """The smoke model of ``case`` with every parameter a DTensor placed by
    ``param_specs``, read as the dry run reads it (``gather_fsdp``)."""
    cfg = get_config(case["arch"], smoke=True).replace(**case["overrides"])
    model = build(cfg, device="cpu")
    model.load_state_dict(case["params"])
    shd.distribute_params(model, shd.param_shardings(mesh, model))
    dryrun.gather_fsdp(model, mesh)
    return model


def plain_name(name: str) -> str:
    """A parameter's name without the parametrization's wrapping."""
    return name.replace("parametrizations.", "").replace(".original", "")


def _dtensor_steps(mesh, case) -> dict:
    """A smoke model's steps with every parameter, the batch and the cache
    placed by the sharding rules on ``mesh``, everything gathered whole:
    the logits, the loss and every gradient, one train step's loss and
    parameters, and two decode steps' logits and cache.  The step's plain
    tensors (positions, masks) count as replicated, as in the dry run."""
    out = {}
    with shd.use_mesh(mesh), implicit_replication():
        model = _dtensor_model(case, mesh)
        batch = _placed(case["batch"], shd.batch_specs_tree(case["batch"]),
                        mesh)
        with torch.no_grad():
            out["logits"] = _whole(model.forward(batch["tokens"])[0])
        state = init_state(model)
        loss, _ = model.loss_fn(batch)
        loss.backward()
        out["loss"] = _whole(loss.detach())
        out["grads"] = {plain_name(n): _whole(p.grad)
                        for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        step = make_train_step(model, lr=case["lr"],
                               microbatches=case["microbatches"])
        state, metrics = step(state, batch)
        out["step_loss"] = _whole(metrics["loss"])
        out["params"] = {plain_name(n): _whole(p.detach())
                         for n, p in model.named_parameters()}
        with torch.inference_mode():
            model = _dtensor_model(case, mesh)
            cache = _placed(case["cache"],
                            shd.cache_specs_tree(case["cache"]), mesh)
            serve = make_serve_step(model)
            out["decode"] = []
            for pos, tokens in case["decode"]:
                tokens = _placed(tokens, shd.batch_specs_tree(tokens),
                                 mesh)["tokens"]
                logits, cache = serve(cache, tokens, pos)
                out["decode"].append(_whole(logits))
            out["cache"] = _whole_tree(cache)
    return out
