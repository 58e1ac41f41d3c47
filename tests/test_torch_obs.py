"""The port's metric-name contract (``repro_torch.obs``).

``EXPECTED_FAMILIES`` below is the port's append-only family inventory:
the port's METRIC-NAME rule (``repro_torch.analysis``) reconciles it with
the literal families registered in ``src/repro_torch``, and the runtime
test holds it against the registry after one request through the port's
server, as ``tests/test_obs.py`` does for the reference.  The two servers
expose the same families, so the list equals the reference's.
"""
import ast
from pathlib import Path

import pytest

from repro_torch.core.workload import TileConfig, WorkloadTable, \
    gemm_workload
from repro_torch.obs import metrics
from repro_torch.serve.client import PredictionClient
from repro_torch.serve.server import PredictionServer

ROOT = Path(__file__).resolve().parents[1]
TILES = [TileConfig(bm, bn, 32) for bm in (64, 128) for bn in (64, 128)]

#: shipped family names — APPEND-ONLY.  Extending this list is fine;
#: renaming or removing an entry breaks scrapers and dashboards.
EXPECTED_FAMILIES = [
    "repro_client_attempt_seconds",
    "repro_client_attempts_total",
    "repro_client_backoff_seconds_total",
    "repro_client_breaker_open_total",
    "repro_client_retries_total",
    "repro_pool_shard_seconds",
    "repro_pool_straggler_redispatch_total",
    "repro_serve_binary_connections_total",
    "repro_serve_binary_inflight",
    "repro_serve_dedup_rows_saved_total",
    "repro_serve_deduped_requests_total",
    "repro_serve_fused_batch_cost",
    "repro_serve_fused_batch_requests",
    "repro_serve_fused_batch_rows",
    "repro_serve_isolated_failures_total",
    "repro_serve_queue_depth",
    "repro_serve_request_seconds",
    "repro_serve_requests_total",
    "repro_serve_shed_total",
    "repro_serve_slow_requests_total",
    "repro_serve_stage_seconds",
    "repro_sweep_predict_table_seconds",
    "repro_sweep_rows_total",
]


def small_table(name="g"):
    return WorkloadTable.tile_lattice(
        gemm_workload(name, 1024, 1024, 1024, precision="fp16"), TILES)


def test_expected_families_equal_the_reference_list():
    tree = ast.parse((ROOT / "tests" / "test_obs.py").read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and [t.id for t in node.targets] == ["EXPECTED_FAMILIES"])
    assert EXPECTED_FAMILIES == ref


@pytest.mark.serve
def test_metric_name_contract():
    # touching every instrumented layer registers every family
    with PredictionServer(port=0, binary_port=0).start() as srv:
        client = PredictionClient(*srv.address)
        client.argmin(small_table("contract"), "b200")
        client.close()
    missing = set(EXPECTED_FAMILIES) - set(metrics.REGISTRY.family_names())
    assert not missing, \
        f"shipped metric families disappeared (breaking change): {missing}"
