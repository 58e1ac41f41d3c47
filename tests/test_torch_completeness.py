"""The port does all that the reference does: every module of ``src/repro``
has its port at the same relative path under ``src/repro_torch``, and every
public top-level name of a reference module exists in its port or is
listed below with what takes its place and why.
"""
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: reference modules with no port, and why
NOT_PORTED = {
    "kernels/_compat.py": "a shim over Pallas versions' CompilerParams "
                          "names; the port has no Pallas",
}

#: reference module -> {public name: (what the port has instead, or None;
#: why)}
MAPPED = {
    "core/microbench.py": {
        "calibrate_host": ("calibrate_device",
                           "the loop measures the device; device='cpu' "
                           "measures the host"),
        "host_suite": ("device_suite", "the same; device='cpu' is the host"),
        "host_suite_result": ("device_suite_result",
                              "the same; device='cpu' is the host"),
    },
    "distributed/sharding.py": {
        "shard_map": ("manual_region",
                      "jax's shard_map over a version shim; the port's "
                      "sharded bodies are per-rank code over "
                      "torch.distributed, marked by manual_region"),
    },
    "kernels/flash_attention/kernel.py": {
        "DEFAULT_BLOCK_Q": (None, "the Pallas grid's query block; the CUDA "
                                  "kernel's tiles are fixed in "
                                  "csrc/flash_attention.cu"),
        "DEFAULT_BLOCK_KV": (None, "the Pallas grid's key block; likewise"),
        "NEG_INF": (None, "the Pallas body's mask value; the CUDA kernel "
                          "keeps its own (-1e30f) in "
                          "csrc/flash_attention.cu"),
    },
    "kernels/rmsnorm/kernel.py": {
        "DEFAULT_BLOCK_ROWS": (None, "the Pallas grid's row block; the CUDA "
                                     "kernel's rows a block are fixed in "
                                     "csrc/rmsnorm.cu"),
    },
    "kernels/ssd/ref.py": {
        "ssd_chunked_jnp": ("ssd_chunked",
                            "the vectorized jnp chunked scan; the port's "
                            "plain chunked scan is one torch function"),
    },
    "launch/hlo_analysis.py": {
        "shape_bytes": (None, "parses XLA HLO shape strings; the port "
                              "traces torch ops and counts tensor bytes"),
    },
    "models/attention.py": {
        "attn_init": ("Attention", "parameters live in an nn.Module"),
    },
    "models/layers.py": {
        "mlp_init": ("MLP", "parameters live in an nn.Module"),
    },
    "models/mla.py": {
        "mla_init": ("MLA", "parameters live in an nn.Module"),
    },
    "models/moe.py": {
        "moe_init": ("MoE", "parameters live in an nn.Module"),
    },
    "models/rglru.py": {
        "rglru_init": ("RGLRU", "parameters live in an nn.Module"),
    },
    "models/ssm.py": {
        "ssm_init": ("SSM", "parameters live in an nn.Module"),
    },
    "models/blocks.py": {
        "BlockDef": ("make_block",
                     "init/apply/cache/decode of a block kind; the port's "
                     "blocks are nn.Modules made by make_block"),
        "ZERO": (None, "a jnp fp32 zero for blocks without an aux loss; "
                       "the port makes it on the input's device "
                       "(blocks._zero)"),
    },
    "train/train_step.py": {
        "TrainState": (None, "a dict subclass naming the state pytree; the "
                             "port's init_state returns a plain dict"),
    },
}


def reference_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def public_names(path: Path) -> set:
    """Names a module defines at its top level (in module-level if/try
    blocks too), without a leading underscore; imports are not counted."""
    names = set()
    stack = list(ast.parse(path.read_text()).body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                names |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif isinstance(node, (ast.If, ast.Try)):
            stack += node.body + node.orelse + getattr(node, "finalbody", [])
            for h in getattr(node, "handlers", []):
                stack += h.body
    return {n for n in names if not n.startswith("_")}


def port_module(rel: str):
    name = "repro_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def test_every_reference_module_has_its_port():
    missing = [rel for rel in reference_modules()
               if not (PORT / rel).is_file()]
    assert missing == sorted(NOT_PORTED)
    for rel in NOT_PORTED:
        assert (REF / rel).is_file()


@pytest.mark.parametrize(
    "rel", [r for r in reference_modules() if r not in NOT_PORTED])
def test_every_public_name_has_its_port(rel):
    mod = port_module(rel)
    mapped = MAPPED.get(rel, {})
    missing = sorted(n for n in public_names(REF / rel) - set(mapped)
                     if not hasattr(mod, n))
    assert not missing, f"{rel}: not in the port: {missing}"
    for name, (instead, why) in mapped.items():
        assert name in public_names(REF / rel), (rel, name)
        assert not hasattr(mod, name), f"{rel}.{name} is ported; unlist it"
        assert why
        if instead is not None:
            assert hasattr(mod, instead), (rel, instead)


def test_the_map_names_only_reference_modules():
    assert set(MAPPED) <= set(reference_modules())
