"""The work counts against hand-worked values and brute force, and their
independence from how the program tiles or chunks the work."""
import json
from pathlib import Path

import pytest

from portbench import counts

HERE = Path(__file__).resolve().parent
DANUBE = json.loads((HERE / "configs" / "h2o-danube-1.8b.json")
                    .read_text())["model"]
MAMBA = json.loads((HERE / "configs" / "mamba2-1.3b.json")
                   .read_text())["model"]


def brute_pairs(s, causal, window):
    return sum(1 for q in range(s) for k in range(s)
               if (not causal or k <= q) and (window <= 0 or k >= q - window))


@pytest.mark.parametrize("s,causal,window", [
    (1, True, 0), (8, True, 0), (8, True, 3), (8, True, 7), (8, True, 100),
    (37, True, 5), (64, True, 63), (64, True, 1), (9, False, 0)])
def test_live_pairs_match_brute_force(s, causal, window):
    assert counts.live_pairs(s, causal, window) == brute_pairs(s, causal,
                                                               window)


def test_hand_worked_counts():
    # queries 0..7 see 1, 2, 3, 4, 4, 4, 4, 4 keys at window 3
    assert counts.live_pairs(8, True, 3) == 26
    assert counts.attention_flops(1, 2, 8, 4, True, 3) == 4 * 4 * 26 * 2
    assert counts.attention_bytes(1, 2, 1, 8, 4) == 2 * (2 * 2 * 8 * 4
                                                          + 2 * 8 * 4)
    # chunk 2 over 4 positions: 3 live pairs a chunk; 2 chunks of
    # 2*3*3 + 1*(2*3*2 + 4*2*3*2) = 78 operations
    assert counts.ssd_work(1, 4, 1, 2, 3, chunk=2) == (156.0, 180.0)
    # danube: 2 x 2560^2 + 2 x 2560 x 640 + 3 x 2560 x 6912 a layer
    assert counts.layer_matmul_params(DANUBE, "local_attn") == 69_468_160
    assert counts.matmul_params(DANUBE) == 24 * 69_468_160
    # mamba2: 2048 x (2 x 4096 + 2 x 128 + 64) + 4096 x 2048 a layer
    assert counts.matmul_params(MAMBA) == 48 * (2048 * 8512 + 4096 * 2048)


def test_prefill_and_train_flops_by_hand():
    s = 8192
    pairs = counts.live_pairs(s, True, 4096)
    want = (2 * counts.matmul_params(DANUBE) * s + 2 * 2560 * 32000
            + 24 * 4 * 80 * 32 * pairs)
    assert counts.prefill_flops(DANUBE, s) == pytest.approx(want, rel=1e-12)
    want = (6 * (counts.matmul_params(DANUBE) + 2560 * 32000) * 8 * 2048
            + 3 * 24 * 4 * 80 * 32 * counts.live_pairs(2048, True, 4096) * 8)
    assert counts.train_flops(DANUBE, 8, 2048) == pytest.approx(want,
                                                                rel=1e-12)


@pytest.mark.parametrize("model,change", [
    (DANUBE, {"attn_chunk": 0}), (DANUBE, {"use_flash_kernel": True}),
    (DANUBE, {"remat": "none", "dtype": "float32"}),
    (MAMBA, {"ssm_chunk": 128}), (MAMBA, {"ssm_chunk": 64}),
    (MAMBA, {"use_flash_kernel": True})])
def test_counts_do_not_follow_the_implementation(model, change):
    other = dict(model, **change)
    for s in (2048, 3000, 8192):
        assert counts.prefill_flops(other, s) == counts.prefill_flops(model,
                                                                      s)
    assert counts.train_flops(other, 8, 2048) == counts.train_flops(
        model, 8, 2048)


def test_bound_takes_the_larger_term():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
