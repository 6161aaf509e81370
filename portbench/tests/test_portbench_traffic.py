"""The traffic generator: one seed, one stream; every seed the same sizes;
every request inside its cell's context."""
import numpy as np
import pytest

from portbench import generator, spec

MIXES = ["docqa", "uniq"]


def _flat(sessions):
    return [t for s in sessions for t in s.turns]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_stream_other_seed_other(mix):
    m = dict(spec.traffic(mix), sessions=96)
    a, b = generator.sessions(m, 7, 1000), generator.sessions(m, 7, 1000)
    c = generator.sessions(m, 2 ** 31 + 9, 1000)
    ta, tb, tc = _flat(a), _flat(b), _flat(c)
    assert all(np.array_equal(x.prompt, y.prompt)
               and x.max_new_tokens == y.max_new_tokens
               for x, y in zip(ta, tb))
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(ta, tc))


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_sends_the_same_sizes_in_the_same_order(mix):
    m = dict(spec.traffic(mix), sessions=96)

    def sizes(seed):
        return [(len(t.prompt), t.max_new_tokens, t.shared_len)
                for t in _flat(generator.sessions(m, seed, 1000))]

    assert sizes(3) == sizes(123456789012)
    assert len(set(sizes(3))) > 1


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_every_request_fits_its_context(cell):
    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    cfg = spec.config(bench, w["config"])
    m = spec.traffic(w["traffic"])
    _, longest = generator.longest(m)
    assert longest <= cfg["engine"]["max_seq"]
    vocab = cfg["model"]["vocab_size"]
    for s in generator.sessions(dict(m, sessions=64), 5, vocab):
        for t in s.turns:
            assert len(t.prompt) + t.max_new_tokens <= longest
            assert 1 <= t.prompt.min() and t.prompt.max() < vocab


def test_docqa_shares_documents_and_uniq_shares_nothing():
    d = generator.sessions(dict(spec.traffic("docqa"), sessions=64), 1, 900)
    assert all(len({t.shared_len for t in s.turns}) == 1
               and s.turns[0].shared_len >= 3072 for s in d)
    assert all(np.array_equal(s.turns[0].prompt[:t.shared_len],
                              t.prompt[:t.shared_len])
               for s in d for t in s.turns)
    assert len({s.doc for s in d}) < len(d)        # Zipf reuse
    u = generator.sessions(dict(spec.traffic("uniq"), sessions=64), 1, 900)
    assert all(t.shared_len == 0 for s in u for t in s.turns)
