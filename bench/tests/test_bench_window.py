"""The window arithmetic of the end-to-end metrics."""
from types import SimpleNamespace

from bench.window import Served, gaps_ms, percentile, tokens_in, ttfts_ms


def _req(first, times):
    return SimpleNamespace(first_token_time=first, token_times=times)


def test_ttft_censored_and_refused():
    served = [Served(1.0, _req(1.5, [1.5])),          # 500 ms
              Served(2.0, _req(None, [])),            # censored at end 4.0
              Served(3.0, refused=True),              # missed: until end
              Served(0.5, _req(0.6, [0.6])),          # due before window
              Served(5.0, _req(5.1, [5.1]))]          # due after window
    got = ttfts_ms(served, 1.0, 4.0, 4.0)
    assert [round(x) for x in got] == [500, 2000, 1000]
    late = [Served(1.0, _req(9.0, [9.0]))]            # first after end
    assert [round(x) for x in ttfts_ms(late, 1.0, 4.0, 6.0)] == [5000]


def test_gaps_end_in_window():
    served = [Served(0.0, _req(0.5, [0.5, 0.9, 1.2, 1.4, 2.5]))]
    got = gaps_ms(served, 1.0, 2.0)
    assert [round(x) for x in got] == [300, 200]
    assert tokens_in(served, 1.0, 2.0) == 2


def test_stall_moves_p99_not_p50():
    """A whole prefill stalls every running row once in 40 gaps: the
    median gap stays, the 99th percentile takes the stall."""
    def times(stall):
        t, out = 0.0, []
        for i in range(400):
            t += 0.5 if (stall and i % 40 == 39) else 0.03
            out.append(t)
        return out
    a = gaps_ms([Served(0.0, _req(0.0, times(False)))], 0.0, 100.0)
    b = gaps_ms([Served(0.0, _req(0.0, times(True)))], 0.0, 100.0)
    assert abs(percentile(b, 50) - percentile(a, 50)) < 1e-6
    assert percentile(a, 99) < 31 and percentile(b, 99) > 400


def test_percentile_is_linear():
    assert percentile([1, 2, 3, 4], 50) == 2.5
    assert percentile([], 50) != percentile([], 50)          # nan


def _done(plen, ntok):
    return SimpleNamespace(prompt=[0] * plen, tokens=[0] * ntok)


def test_sample_spreads_over_the_batch():
    """The longest request and others drawn from the seed, up to the
    count, skipping any that would pass the token budget."""
    from bench import check
    fin = [_done(100, 10) for _ in range(20)] + [_done(900, 100)] \
        + [_done(1400, 100)]
    budget = {"requests": 8, "seq_tokens": 2400}
    got = check.sample(fin, 3, budget)
    assert got[0] is fin[21] and len(got) == 8
    assert fin[20] not in got
    assert sum(len(r.prompt) + len(r.tokens) for r in got) <= 2400
    assert check.sample(fin, 3, budget) == got


def test_queue_by_thirds():
    from bench.calibrate import queue_thirds
    served = [Served(0.0, _req(2.5, [2.5])),          # waits in the first
              Served(4.0, _req(None, [])),            # never served
              Served(1.0, refused=True)]
    got = queue_thirds(served, 0.0, 6.0, step=0.5)
    assert got == [1.0, 0.25, 1.0]
