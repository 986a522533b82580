"""The traffic generator: sizes and ids repeat by seed; every block of
requests holds every size once."""
import numpy as np

from portbench.harness import traffic

MIX = traffic.load("long-prompt")


def _take(seed, n, vocab=49152):
    reqs = traffic.Requests(MIX, vocab, seed)
    return [reqs.next() for _ in range(n)]


def test_levels_span_the_mix():
    p, o = traffic.levels(MIX["prompt"]), traffic.levels(MIX["output"])
    assert (p[0], p[-1], len(p)) == (1024, 4032, 49)
    assert o == list(range(16, 65))
    assert 2150 < np.mean(p) < 2250          # log-uniform's mean: 2195
    assert max(p) + max(o) <= MIX["max_len"]


def test_same_seed_same_requests():
    a, b = _take(2**31 + 5, 60), _take(2**31 + 5, 60)
    assert [len(x) for x, _ in a] == [len(x) for x, _ in b]
    assert all(np.array_equal(x, y) and n == m
               for (x, n), (y, m) in zip(a, b))
    c = _take(2**31 + 6, 60)
    assert [len(x) for x, _ in a] != [len(x) for x, _ in c]


def test_every_block_holds_every_size_and_ids_in_vocab():
    k = MIX["prompt"]["levels"]
    got = _take(7, 2 * k, vocab=1000)
    for blk in (got[:k], got[k:]):
        assert sorted(len(x) for x, _ in blk) == traffic.levels(MIX["prompt"])
        assert sorted(n for _, n in blk) == traffic.levels(MIX["output"])
    ids = np.concatenate([x for x, _ in got])
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < 1000
