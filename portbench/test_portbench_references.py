"""A configuration's own reference module, found by the configuration's
name: every cell's yardstick takes its module exactly where there is one;
the two real configurations have none, resolve to the default equations
and counts and draw the same weights as before the lookup; the toy
``toy-moe``, whose ``moe`` block the defaults do not know and whose dense
prefix it replaces, runs correct through its module
``references/toy-moe.py``, its control and a capacity fault fail, and a
traced run prices its work and its flash calls with the module's counts.
A module that takes anything of the program is refused."""
import hashlib
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import counts, harness, reference, toy, toy_moe
from portbench.traffic import PrefillTraffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2**31 + 77
MOE_CELL = "toy-moe.toy-prefill"
REAL = {c["name"]: c for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]}
# sha256 over every leaf's name and bytes, in draw order, of make_weights at
# SEED on the CPU, and of repr(param_spec) of the real configurations: as
# computed on the tree before configurations could bring their own modules
WEIGHTS_SHA = {
    "toy-danube":
        "6cbdf1aeb1e551303e337892f66078c15874c7879bf0e5a51e8d0321330c42d8",
    "toy-mamba":
        "3b1eeec677af869ca41dd8248b385f916d2ccb32445fd0e1d5194ac7c929a2f1",
}
SPEC_SHA = {
    "h2o-danube-1.8b":
        "a77fe0fc58f06d5e3f12016441b31409ca347744e8af1c0a5f4cd86a8d015932",
    "mamba2-1.3b":
        "7287318b0ea9ea7f57d24b931c6ade0dc4433b06b0adbe52959885c31db05c22",
}
# prefill_flops at S = 200, 2048, 3669, 8192 and train_flops(8, 2048), as
# computed on that tree
PARENT_COUNTS = {
    "h2o-danube-1.8b": ([671997952000.0, 7344809574400.0, 13888947896320.0,
                         33502418698240.0], 184324561305600.0),
    "mamba2-1.3b": ([495972679680.0, 5389731397632.0, 9642576347136.0,
                     21558307749888.0], 139471311863808.0),
}
# (FLOPs, bytes) of each flash call at those S, as flash_roofline priced
# them before the count was the yardstick's: danube's 24 layers alike
PARENT_CALLS = {
    "h2o-danube-1.8b": [
        [(205824000.0, 2560000.0)] * 24,
        [(21485322240.0, 26214400.0)] * 24,
        [(68941977600.0, 46963200.0)] * 24,
        [(257760952320.0, 104857600.0)] * 24],
    "mamba2-1.3b": [[]] * 4,
}
# the cells of the benchmark before any configuration brought a module
PINNED = ("h2o-danube-1.8b.chat-ragged", "h2o-danube-1.8b.pretrain-8x2048",
          "h2o-danube-1.8b.rag-chunks", "mamba2-1.3b.rag-chunks")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.write_root(tmp_path_factory.mktemp("refbench"))


def run(root, cell, **kw):
    kw.setdefault("trace", False)
    return harness.run_cell(cell, seed=SEED, seconds=0.3, root=root,
                            device="cpu", **kw)


def weights_sha(weights) -> str:
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------- the four cells, pinned

def resolves_to_the_defaults(cell):
    assert not cell.own.is_file()
    ys = harness.yardstick(cell)
    assert ys.own is None
    assert ys.param_spec(cell.model) == reference.param_spec(cell.model)
    assert ys.Reference is reference.Reference
    assert ys.counts.prefill_flops is counts.prefill_flops
    assert ys.counts.train_flops is counts.train_flops
    assert ys.counts.attention_layers is counts.attention_layers
    assert ys.counts.attention_calls is counts.attention_calls


@pytest.mark.parametrize("workload", PINNED)
def test_real_cells_resolve_to_the_default_module(workload):
    resolves_to_the_defaults(harness.load_cell(workload))


# ------------------------------------------- every cell, its own yardstick

def follows_its_module(cell):
    """The cell's yardstick loads ``references/<config>.py`` exactly where
    it exists, and takes from it the spec, the ``Reference`` class and each
    count that the module defines."""
    ys = harness.yardstick(cell)
    if not cell.own.is_file():
        assert ys.own is None
        return
    own = ys.own
    assert own is not None and Path(own.__file__) == cell.own
    assert ys.param_spec(cell.model) == reference.param_spec(
        cell.model, getattr(own, "KINDS", None))
    assert ys.Reference is getattr(own, "Reference", reference.Reference)
    for name in harness.COUNTS:
        assert getattr(ys.counts, name) is getattr(own, name,
                                                   getattr(counts, name))


@pytest.mark.parametrize("workload", sorted(
    w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
    ["workloads"]))
def test_every_cell_resolves_to_its_own_yardstick(workload):
    follows_its_module(harness.load_cell(workload))


@pytest.fixture(scope="module")
def real_with_module(tmp_path_factory):
    return toy.write_real_with_module(tmp_path_factory.mktemp("realmod"))


def test_a_cell_with_a_module_resolves_to_it(real_with_module):
    """The real benchmark with toy-moe's cell added as a later PR adds it:
    the new cell takes its module, the four pinned cells the defaults."""
    bench = json.loads((real_with_module / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        follows_its_module(harness.load_cell(w["name"], real_with_module))
    cell = harness.load_cell(toy.MODULE_CELL, real_with_module)
    assert harness.yardstick(cell).own is not None
    for workload in PINNED:
        resolves_to_the_defaults(harness.load_cell(workload,
                                                   real_with_module))


def ignoring(part):
    """``harness.yardstick`` with one part of the module left out: the
    whole module, its ``KINDS``, its ``Reference`` or one count."""
    whole = harness.yardstick

    def yardstick(cell):
        ys = whole(cell)
        bare = whole(SimpleNamespace(own=cell.own.with_name("absent.py")))
        if part == "module":
            return bare
        if part == "KINDS":
            ys.param_spec = bare.param_spec
        elif part == "Reference":
            ys.Reference = bare.Reference
        else:
            setattr(ys.counts, part, getattr(bare.counts, part))
        return ys
    return yardstick


@pytest.mark.parametrize("part", ("module", "KINDS", "Reference")
                         + harness.COUNTS)
def test_a_yardstick_that_ignores_the_module_fails_the_check(
        real_with_module, part, monkeypatch):
    cell = harness.load_cell(toy.MODULE_CELL, real_with_module)
    follows_its_module(cell)
    monkeypatch.setattr(harness, "yardstick", ignoring(part))
    # the default spec raises on the module's kind ``moe``
    with pytest.raises((AssertionError, ValueError)):
        follows_its_module(cell)


@pytest.mark.parametrize("model", [toy.DANUBE, toy.MAMBA],
                         ids=lambda m: m["name"])
def test_weights_are_the_parents(root, model):
    cell = harness.load_cell(f"{model['name']}.toy-prefill", root)
    w = harness.yardstick(cell).make_weights(cell.model, SEED, "cpu")
    assert weights_sha(w) == WEIGHTS_SHA[model["name"]]


@pytest.mark.parametrize("config", sorted(SPEC_SHA))
def test_real_specs_and_counts_are_the_parents(config):
    m = json.loads((ROOT / REAL[config]["file"]).read_text())["model"]
    spec = repr(reference.param_spec(m)).encode()
    assert hashlib.sha256(spec).hexdigest() == SPEC_SHA[config]
    prefill, train = PARENT_COUNTS[config]
    assert [counts.prefill_flops(m, s) for s in (200, 2048, 3669, 8192)] \
        == prefill
    assert counts.train_flops(m, 8, 2048) == train
    want = 24 if config == "h2o-danube-1.8b" else 0
    assert counts.attention_layers(m) == want
    assert [counts.attention_calls(m, s) for s in (200, 2048, 3669, 8192)] \
        == PARENT_CALLS[config]


def parent_flash_roofline(t):
    """``metrics/flash_roofline.py`` as it read before its calls were the
    yardstick's count."""
    secs = t.kernel_seconds("attn_fwd_")
    m = t.model
    kinds = counts.block_kinds(m)
    window = m.get("window", 0) if "local_attn" in kinds else 0
    hq, hkv, d = m["n_heads"], m["n_kv_heads"], counts.head_dim(m)
    bound = sum(
        p["launches"].get("flash_attention", 0) * counts.bound_s(
            counts.attention_flops(1, hq, p["len"], d, True, window),
            counts.attention_bytes(1, hq, hkv, p["len"], d))
        for p in t.prompts)
    return 100.0 * bound / secs


@pytest.mark.parametrize("traffic", ["rag-chunks", "chat-ragged"])
def test_flash_roofline_reads_danube_as_before(traffic):
    """To the last digit, over a cycle of the real mix's lengths, every
    layer or all but one taking the kernel."""
    cell = harness.load_cell(f"h2o-danube-1.8b.{traffic}")
    lengths = PrefillTraffic(cell.mix, cell.model["vocab"], SEED).cycle
    t = SimpleNamespace(
        model=cell.model, counts=harness.yardstick(cell).counts,
        kernel_seconds=lambda part: 0.731 if part == "attn_fwd_" else 0.0,
        prompts=[{"len": n, "launches": {"flash_attention": 24 - i % 2}}
                 for i, n in enumerate(lengths)])
    read = harness.reader(cell, "flash_roofline")
    assert read(t) == parent_flash_roofline(t)


# ---------------------------------------------------- toy-moe, one new file

def test_the_module_is_found_by_the_configurations_name(root):
    cell = harness.load_cell(MOE_CELL, root)
    assert cell.own == root / "portbench" / "references" / "toy-moe.py"
    ys = harness.yardstick(cell)
    assert ys.own.KINDS == {"moe": ys.own.moe_leaves,
                            "attn": ys.own.prefix_leaves}
    assert issubclass(ys.Reference, reference.Reference)
    names = [n for n, *_ in ys.param_spec(cell.model)]
    assert names[:4] == ["tok_embed", "final_norm", "prefix.0.ln1",
                         "prefix.0.attn.wq"]
    assert "groups.1.b0.moe.shared.wd" in names and names[-1] == "lm_head"
    w = ys.make_weights(cell.model, SEED, "cpu")
    assert w["groups.0.b0.moe.w_router"].dtype == torch.float32


def test_without_its_module_the_kind_is_unknown(tmp_path):
    bare = toy.write_root(tmp_path)
    (bare / "portbench" / "references" / "toy-moe.py").unlink()
    with pytest.raises(ValueError, match="no block kind 'moe'"):
        run(bare, MOE_CELL)


PROGRAM_IMPORTS = {
    "import": "import repro_torch.models.moe\n",
    "from": "from repro_torch.models.moe import capacity\n",
    "by_name": "import importlib\n"
               "capacity = importlib.import_module("
               "'repro_torch.models.moe').capacity\n",
}


@pytest.mark.parametrize("how", sorted(PROGRAM_IMPORTS))
def test_a_module_that_takes_the_program_is_refused(tmp_path, how):
    bare = toy.write_root(tmp_path)
    path = bare / "portbench" / "references" / "toy-moe.py"
    path.write_text(path.read_text() + PROGRAM_IMPORTS[how])
    with pytest.raises(ValueError, match="repro_torch"):
        harness.yardstick(harness.load_cell(MOE_CELL, bare))


def test_a_tagged_end_to_end_metric_reports_its_quantity(tmp_path):
    """``prompt_tok_s.<tag>``: the run's prompt_tok_s, for the cells the
    entry lists, under a bound of its own."""
    bare = toy.write_root(tmp_path)
    bench = json.loads((bare / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({
        "name": "prompt_tok_s.moe", "unit": "tokens/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [MOE_CELL]})
    (bare / "BENCHMARK.json").write_text(json.dumps(bench))
    got = run(bare, MOE_CELL)["metrics"]
    assert got["prompt_tok_s.moe"] == got["prompt_tok_s"]
    assert "prompt_tok_s.moe" not in run(bare, "toy-danube.toy-prefill")[
        "metrics"]


def test_a_tagged_per_layer_metric_is_read_by_its_quantitys_reader(
        tmp_path):
    """``prefill_mfu.<tag>``, with no reader of its own: prefill_mfu's
    reading, for the cells the entry lists, moving their own end-to-end
    metric; a name with a file of its own keeps it."""
    bare = toy.write_root(tmp_path)
    metrics = bare / "portbench" / "metrics"
    shutil.copy(HERE / "metrics" / "prefill_mfu.py", metrics)
    bench = json.loads((bare / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({
        "name": "prompt_tok_s.moe", "unit": "tokens/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [MOE_CELL]})
    bench["per_layer"].append({
        "name": "prefill_mfu.moe", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "toy",
        "moves": "prompt_tok_s.moe", "workloads": [MOE_CELL]})
    (bare / "BENCHMARK.json").write_text(json.dumps(bench))
    assert harness.reader_path(metrics, "prefill_mfu.moe") == \
        metrics / "prefill_mfu.py"
    assert harness.reader_path(metrics, "toy_units") == \
        metrics / "toy_units.py"
    r = run(bare, MOE_CELL, trace=True)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    traffic = PrefillTraffic(toy.MIXES["toy-prefill"], toy.MOE["vocab"],
                             SEED)
    flops = sum(toy_moe.prefill_flops(toy.MOE, len(traffic.ids(i)))
                for i in range(int(got["toy_units"])))
    want = 100.0 * flops / r["device"]["window_s"] / counts.PEAK_BF16_FLOPS
    assert got["prefill_mfu.moe"] == pytest.approx(want, rel=1e-12)
    assert "prefill_mfu.moe" not in run(
        bare, "toy-danube.toy-prefill", trace=True)["metrics"]


def test_the_per_layer_tail_is_the_end_to_end_arithmetic(tmp_path):
    """``ttft_p95_ms.chat``, read per layer from a traced window, is the
    95th percentile that ``ttft_p95_ms`` takes over the same requests."""
    bare = toy.write_root(tmp_path)
    shutil.copy(HERE / "metrics" / "ttft_p95_ms.chat.py",
                bare / "portbench" / "metrics")
    bench = json.loads((bare / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "ttft_p95_ms.chat", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "toy", "moves": "prompt_tok_s",
        "workloads": [MOE_CELL]})
    (bare / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(bare, MOE_CELL, trace=True)
    assert r["attempted"] > 2
    assert r["metrics"]["ttft_p95_ms.chat"]["value"] == pytest.approx(
        r["_run"]["e2e"]["ttft_p95_ms"], rel=1e-12)


def test_toy_moe_runs_correct_and_its_control_fails(root):
    r = run(root, MOE_CELL, control=True)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    limits = json.loads((root / "portbench" / "limits" /
                         f"{MOE_CELL}.json").read_text())
    control = r["_run"]["control"]
    assert not harness.passed(harness.compare(control, limits)), control


def test_dropped_tokens_fail(root, monkeypatch):
    """A capacity of one slot an expert drops most assignments: the check,
    through the module's equations, sees it."""
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "capacity", lambda cfg, t: 1)
    r = run(root, MOE_CELL)
    assert r["correct"] is False
    assert r["checks"]["logit_err"]["value"] > 1e-2


def test_hand_counted_work():
    m = toy.MOE
    # attention 64 x 64 x 2 + 64 x 32 x 2 = 12288 a layer; the prefix adds
    # its MLP, 3 x 64 x 96; a moe layer its router, 64 x 8, and two routed
    # experts and the shared one, 3 x 3 x 64 x 32
    assert toy_moe.layer_active_params(m, "attn") == 12288 + 18432
    assert toy_moe.layer_active_params(m, "moe") == 12288 + 512 + 18432
    assert toy_moe.active_params(m) == 30720 + 2 * 31232
    assert toy_moe.attention_layers(m) == 3
    # S 48: 1176 live pairs, 4 x 16 x 4 operations each in three layers
    assert toy_moe.prefill_flops(m, 48) == (2 * 93184 * 48 + 2 * 64 * 128
                                            + 3 * 256 * 1176)
    assert toy_moe.train_flops(m, 2, 32) == (6 * (93184 + 64 * 128) * 64
                                             + 3 * 3 * 256 * 528 * 2)


# a module whose flash calls are not the default's GQA calls: each priced
# at twice the default's operations and three times its bytes
OTHER_CALLS = '''

def attention_calls(m, s):
    return [(2 * f, 3 * b) for f, b in counts.attention_calls(
        dict(m, pattern=["attn"], first_dense=0), s)]
'''
FLASH_S = 1e-3          # the flash kernel's device seconds, as if traced


def test_traced_run_prices_with_the_modules_counts(tmp_path, monkeypatch):
    """prefill_mfu, flash_call_share and flash_roofline, as the real
    benchmark has them, added to the toy root, under a module whose flash
    calls differ from the default's: they read the module's counts (the
    default count has no ``moe`` kind and would raise).  The CPU launches
    no kernel, so the flash calls are counted and a device time is put in
    the trace by hand."""
    root = toy.write_root(tmp_path)
    module = root / "portbench" / "references" / "toy-moe.py"
    module.write_text(module.read_text() + OTHER_CALLS)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("prefill_mfu", "flash_call_share", "flash_roofline"):
        shutil.copy(HERE / "metrics" / f"{name}.py",
                    root / "portbench" / "metrics" / f"{name}.py")
        bench["per_layer"].append({
            "name": name, "unit": "%", "better": "higher",
            "source": "device_trace", "layer": "toy",
            "moves": "prompt_tok_s", "workloads": [MOE_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from repro_torch.kernels.flash_attention import kernel
    whole_mha, whole_reduce = kernel.mha, harness.Tracer.reduce

    def counted(*a, **kw):
        kernel.launches += 1
        return whole_mha(*a, **kw)

    def with_flash(tracer):
        reduced = whole_reduce(tracer)
        reduced["kernels"]["attn_fwd_toy"] = FLASH_S
        return reduced
    monkeypatch.setattr(kernel, "mha", counted)
    monkeypatch.setattr(harness.Tracer, "reduce", with_flash)
    r = run(root, MOE_CELL, trace=True)
    assert r["correct"] is True
    got = {k: v["value"] for k, v in r["metrics"].items()}
    traced = int(got["toy_units"])             # the traced requests
    traffic = PrefillTraffic(toy.MIXES["toy-prefill"], toy.MOE["vocab"],
                             SEED)
    lengths = [len(traffic.ids(i)) for i in range(traced)]
    flops = sum(toy_moe.prefill_flops(toy.MOE, n) for n in lengths)
    want = 100.0 * flops / r["device"]["window_s"] / counts.PEAK_BF16_FLOPS
    assert got["prefill_mfu"] == pytest.approx(want, rel=1e-12)
    # each request's 3 layers each launched the kernel once
    assert got["flash_call_share"] == 100.0
    ys = harness.yardstick(harness.load_cell(MOE_CELL, root))
    assert ys.counts.attention_calls is ys.own.attention_calls

    def roofline(calls):
        return 100.0 * sum(counts.bound_s(*c) for n in lengths
                           for c in calls(toy.MOE, n)) / FLASH_S
    assert got["flash_roofline"] == pytest.approx(
        roofline(ys.own.attention_calls), rel=1e-12)
    assert got["flash_roofline"] > 1.5 * roofline(toy_moe.attention_calls)


def test_a_module_replaces_the_prefixs_kind(root, monkeypatch):
    """toy-moe's dense prefix (kind ``attn``) takes the module's leaves and
    equations, as a model whose prefix is not GQA would: with the defaults'
    ``attn`` leaves and block made to raise, the cell still runs correct
    and its fp8 control still fails."""
    def default_used(*a, **kw):
        raise AssertionError("the default attn kind was used")
    monkeypatch.setitem(reference.KINDS, "attn", default_used)
    monkeypatch.setattr(reference.Reference, "attn_block", default_used)
    cell = harness.load_cell(MOE_CELL, root)
    ys = harness.yardstick(cell)
    assert ys.own.KINDS["attn"] is ys.own.prefix_leaves
    names = [n for n, *_ in ys.param_spec(cell.model)]
    assert [n for n in names if n.startswith("prefix.0.")] == [
        "prefix.0." + n for n in ("ln1", "attn.wq", "attn.wk", "attn.wv",
                                  "attn.wo", "ln2", "mlp.wg", "mlp.wu",
                                  "mlp.wd")]
    r = run(root, MOE_CELL, control=True)
    assert r["correct"] is True, r["checks"]
    limits = json.loads((root / "portbench" / "limits" /
                         f"{MOE_CELL}.json").read_text())
    control = r["_run"]["control"]
    assert not harness.passed(harness.compare(control, limits)), control
