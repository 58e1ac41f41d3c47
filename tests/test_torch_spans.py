"""Compute spans (``repro_torch.obs.compute``) on the CPU: a prefill or a
training step records its tree of spans only while a ``torch.profiler``
trace is being taken, on the profiler's own clock, whichever path the
attention and SSM dispatch take; the ring counts what it evicts."""
import time
from collections import deque

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402,E501

from repro_torch.configs import h2o_danube_1p8b, mamba2_1p3b  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.obs import compute, metrics, trace  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

BLOCK_SPANS = {"norm", "attention", "mlp", "ssm"}


@pytest.fixture(autouse=True)
def empty_ring():
    compute.clear()
    yield
    compute.clear()


DANUBE = h2o_danube_1p8b.SMOKE
MAMBA = mamba2_1p3b.SMOKE


def model_of(cfg, **over):
    return build(cfg.replace(**over), "cpu").init(
        torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def danube():
    return model_of(DANUBE, use_flash_kernel=True)


@pytest.fixture(scope="module")
def mamba():
    return model_of(MAMBA, use_flash_kernel=True)


def ids(s):
    return torch.randint(0, 128, (1, s),
                         generator=torch.Generator().manual_seed(s))


def traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


def children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def test_nothing_records_without_a_profiler(danube, mamba):
    for model in (danube, mamba):
        serve_step.make_prefill(model)(ids(128))
    assert trace.recent_spans() == [] and compute.compute_spans() == []
    assert compute.compute_span("norm") is compute.compute_span("mlp")


def test_the_kill_switch_silences_compute_spans(danube):
    metrics.set_enabled(False)
    try:
        traced(serve_step.make_prefill(danube), ids(128))
    finally:
        metrics.set_enabled(True)
    assert compute.compute_spans() == []


@pytest.mark.parametrize("arch", ["danube", "mamba"])
def test_one_prefill_is_one_root_over_its_blocks(arch, request):
    model = request.getfixturevalue(arch)
    traced(serve_step.make_prefill(model), ids(128))
    spans = compute.compute_spans()
    (root,) = [s for s in spans if s.parent_id == 0]
    assert root.name == "prefill"
    assert root.attrs == {"tokens": 128}
    assert {s.trace_id for s in spans} == {root.trace_id}
    assert len({s.span_id for s in spans}) == len(spans)
    kids = children(spans, root)
    assert kids == [s for s in spans if s is not root]
    per_block = (["norm", "attention", "norm", "mlp"] if arch == "danube"
                 else ["norm", "ssm"])
    assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] \
        == per_block * model.cfg.n_layers
    for s in kids:
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
        # on the CPU the device interval is the host interval
        assert s.device_s == s.duration_s
    assert sum(s.device_s for s in kids) <= root.device_s


def one_span_a_layer(model, name, s):
    traced(serve_step.make_prefill(model), ids(s))
    (root,) = compute.compute_spans("prefill")
    assert root.attrs == {"tokens": s}
    spans = compute.compute_spans(name)
    assert len(spans) == model.cfg.n_layers
    assert all(sp.parent_id == root.span_id and sp.attrs == {}
               for sp in spans)


@pytest.mark.parametrize("s", [128, 96], ids=["flash", "plain"])
def test_attention_spans_cover_each_dispatch_path(danube, s):
    one_span_a_layer(danube, "attention", s)


@pytest.mark.parametrize("kernel, s", [(True, 96), (False, 96), (True, 100),
                                       (False, 100)],
                         ids=["kernel", "chunked", "sequential",
                              "sequential-plain"])
def test_ssm_spans_cover_each_dispatch_path(kernel, s):
    one_span_a_layer(model_of(MAMBA, use_flash_kernel=kernel), "ssm", s)


def test_spans_share_the_profilers_clock(danube):
    def body():
        with compute.compute_span("outer", device="cpu"):
            with record_function("probe"):
                serve_step.make_prefill(danube)(ids(96))
    _, prof = traced(body)
    (outer,) = compute.compute_spans("outer")
    (probe,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "probe"]
    assert outer.start_ns <= probe.start_ns() <= probe.end_ns() \
        <= outer.end_ns
    # the prefill ran inside the probe, so its root lies inside it too
    (root,) = compute.compute_spans("prefill")
    assert root.parent_id == outer.span_id
    assert probe.start_ns() <= root.start_ns <= root.end_ns \
        <= probe.end_ns()


@pytest.mark.parametrize("remat, microbatches", [("none", 1),
                                                 ("block", 2)])
def test_a_train_step_is_its_two_phases(remat, microbatches):
    model = model_of(DANUBE, remat=remat)
    state = ts.init_state(model)
    step = ts.make_train_step(model, lr=1e-3, microbatches=microbatches)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 128, (2, 32), generator=g),
             "labels": torch.randint(0, 128, (2, 32), generator=g)}
    traced(step, state, batch)
    spans = compute.compute_spans()
    (root,) = [s for s in spans if s.parent_id == 0]
    assert root.name == "train_step" and root.attrs == {"tokens": 64}
    kids = sorted(children(spans, root), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["forward_backward", "optimizer"]
    assert len(spans) == 3 and not BLOCK_SPANS & {s.name for s in spans}
    assert all(s.attrs == {} for s in kids)
    assert sum(s.device_s for s in kids) <= root.device_s


def test_the_ring_counts_what_it_evicts(monkeypatch):
    monkeypatch.setattr(trace, "_SPANS", deque(maxlen=4))

    def six():
        for i in range(6):
            with compute.compute_span("unit", "i", i):
                pass
    traced(six)
    assert compute.evicted() == 2
    assert [s.attrs["i"] for s in compute.compute_spans()] == [2, 3, 4, 5]
    compute.clear()
    assert compute.evicted() == 0 and compute.compute_spans() == []


def test_serve_spans_are_on_the_same_clock():
    before = time.time_ns()
    sp = trace.record_span("unit.op", trace.new_trace_id(), 0.0)
    with trace.span("unit.ctx", sp.trace_id):
        pass
    after = time.time_ns()
    ctx = trace.recent_spans(trace_id=sp.trace_id, name="unit.ctx")[0]
    for s in (sp, ctx):
        assert before - 1000 <= s.start_ns <= after + 1000
        assert s.device is None and s.parent_id == 0 and s.span_id > 0
    assert compute.compute_spans() == []
