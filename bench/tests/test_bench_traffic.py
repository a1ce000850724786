"""The traffic generator: determinism by seed, the same work for every
seed, the length moments of the mixes, and document sharing."""
import numpy as np

from bench import traffic

VOCAB = 92544


def _gen(name, seed, horizon=60.0):
    return traffic.generate(traffic.load(name), seed, horizon, VOCAB)


def test_same_seed_same_requests():
    a, b = _gen("chat", 2**31 + 7), _gen("chat", 2**31 + 7)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.due == y.due and x.max_new == y.max_new
        assert np.array_equal(x.prompt, y.prompt)


def test_seeds_share_the_work():
    a, b = _gen("batch", 1), _gen("batch", 2)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    assert any(len(x.prompt) != len(y.prompt) for x, y in zip(a, b))


def test_chat_moments():
    mix = traffic.load("chat")
    reqs = _gen("chat", 3, horizon=600.0)
    plen = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.max_new for r in reqs])
    assert abs(np.median(plen) / mix["prompt"]["median"] - 1) < 0.05
    assert abs(np.median(outs) / mix["output"]["median"] - 1) < 0.05
    assert plen.min() >= 64 and plen.max() <= 3072
    assert outs.min() >= 16 and outs.max() <= 1008
    dues = np.array([r.due for r in reqs])
    assert np.all(np.diff(dues) >= 0)
    rate = mix["arrivals"]["rate"]
    assert abs(len(reqs) / 600.0 / rate - 1) < 0.1
    for r in reqs:
        assert r.prompt.dtype == np.int32
        assert r.prompt.min() >= 0 and r.prompt.max() < VOCAB


def test_backlog_all_due_at_start():
    reqs = _gen("batch", 4)
    assert len(reqs) == traffic.load("batch")["arrivals"]["count"]
    assert all(r.due == 0.0 for r in reqs)


def test_docqa_sessions_share_documents():
    mix = traffic.load("docqa")
    reqs = _gen("docqa", 5, horizon=300.0)
    doc = mix["sessions"]["doc_tokens"]
    heads = {}
    for r in reqs:
        heads.setdefault(r.prompt[:doc].tobytes(), []).append(r)
    sizes = [len(v) for v in heads.values()]
    assert max(sizes) == mix["sessions"]["turns"]
    q = [len(r.prompt) - doc for r in reqs]
    assert min(q) >= mix["sessions"]["question_min"]
    assert max(q) <= mix["sessions"]["question_max"]
    assert abs(np.median([r.max_new for r in reqs]) / 32 - 1) < 0.1
    rate = mix["arrivals"]["rate"]
    assert abs(len(reqs) / 300.0 / rate - 1) < 0.2


def test_bursts_share_due_times():
    mix = traffic.load("chat")
    mix["arrivals"] = dict(mix["arrivals"], burst=4)
    reqs = traffic.generate(mix, 6, 600.0, VOCAB)
    dues = np.array([r.due for r in reqs])
    _, counts = np.unique(dues, return_counts=True)
    assert set(counts) == {4}
    assert abs(len(reqs) / 600.0 / mix["arrivals"]["rate"] - 1) < 0.1
