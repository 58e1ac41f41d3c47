"""Every seed offers each mix's histogram whole, its longest request
included; the order and the token ids follow the seed."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

HERE = Path(__file__).resolve().parent
SEEDS = (0, 1, 2**31 + 11, 2**40 + 3, -5)
PREFILL = sorted(p.stem for p in (HERE / "traffic").glob("*.json")
                 if json.loads(p.read_text())["kind"] == "prefill")


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", PREFILL)
def test_every_seed_offers_the_same_histogram(name):
    m = mix(name)
    cycle = traffic.cycle_lengths(m)
    first = None
    for seed in SEEDS:
        t = traffic.PrefillTraffic(m, 32000, seed)
        lengths = [t.length(i) for i in range(3 * len(cycle))]
        hist = Counter(lengths)
        assert hist == Counter(cycle * 3)
        for c in range(3):
            assert max(lengths[c * len(cycle):(c + 1) * len(cycle)]) == \
                t.longest()
        first = first or lengths
    assert any(traffic.PrefillTraffic(m, 32000, s).length(0) != first[0]
               or traffic.PrefillTraffic(m, 32000, s).length(1) != first[1]
               for s in SEEDS)


def test_rag_chunks_are_4_to_16_chunks():
    assert traffic.cycle_lengths(mix("rag-chunks")) == \
        [512 * k for k in range(4, 17)]


def test_chat_lengths_are_ragged_and_clipped():
    cycle = traffic.cycle_lengths(mix("chat-ragged"))
    assert min(cycle) >= 200 and max(cycle) == 4096
    assert cycle.count(4096) >= 1
    assert sum(n % 128 == 0 for n in cycle) < len(cycle) // 10
    assert 1000 < float(np.median(cycle)) < 1400


def test_ids_follow_the_seed_alone():
    m = mix("rag-chunks")
    a = traffic.PrefillTraffic(m, 32000, 2**31 + 5)
    b = traffic.PrefillTraffic(m, 32000, 2**31 + 5)
    c = traffic.PrefillTraffic(m, 32000, 2**31 + 6)
    assert np.array_equal(a.ids(7), b.ids(7))
    assert not np.array_equal(a.ids(7)[:64], c.ids(7)[:64])
    assert a.ids(3).max() < 32000 and a.ids(3).min() >= 0


def test_check_sample_holds_the_longest():
    lengths = [5, 9, 2, 9, 1, 4, 7]
    for seed in SEEDS:
        s = traffic.check_sample(lengths, 3, seed)
        assert len(s) == 3 and 1 in s and len(set(s)) == 3
    assert traffic.check_sample(lengths, 20, 0) == list(range(7))


def test_train_batches():
    t = traffic.TrainBatches(mix("pretrain-8x2048"), 32000, 2**31 + 1)
    b = t.batch_at(0)
    assert b["tokens"].shape == (8, 2048) and b["labels"].shape == (8, 2048)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].max() < 4096
    assert np.array_equal(t.batch_at(3)["tokens"], t.batch_at(3)["tokens"])
    assert not np.array_equal(t.batch_at(3)["tokens"], b["tokens"])
    rows = {r.tobytes() for r in b["tokens"]}
    assert len(rows) == 8


def test_train_batches_are_the_ports_arithmetic(monkeypatch):
    """Given the port's seeding, the copy makes the port's batches bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    monkeypatch.setattr(traffic, "seed_words", lambda seed, *more:
                        np.random.SeedSequence([seed, more[-1]]))
    cfg = get_config("h2o-danube-1.8b")
    port = SyntheticLMData(cfg, batch=2, seq_len=64, seed=123)
    copy = traffic.TrainBatches({"batch": 2, "seq": 64}, cfg.vocab, 123)
    for step in (0, 5):
        want, got = port.batch_at(step), copy.batch_at(step)
        for k in ("tokens", "labels"):
            assert np.array_equal(want[k], got[k])
