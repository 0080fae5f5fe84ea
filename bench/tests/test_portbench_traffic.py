"""The traffic generators: the same seed gives the same inputs, and the
sizes are the ones the cells state."""

import math

import numpy as np

from bench.data import tweets
from bench.drivers import serve_loop
from bench.harness.cell import load_cell
from bench.harness.seeds import stream_seed

LONGDOC = load_cell("enrich.deepseek-coder-33b.longdoc").traffic


def test_longdoc_sizes_are_log_uniform_strata():
    sizes = serve_loop.prompt_lengths(LONGDOC)
    assert len(sizes) == 16 and sizes == sorted(sizes)
    assert 512 < sizes[0] < 600 and 7000 < sizes[-1] < 8192
    ratios = [b / a for a, b in zip(sizes, sizes[1:])]
    assert max(ratios) - min(ratios) < 0.01        # even in log space
    assert math.isclose(ratios[0], 16 ** (1 / 16), rel_tol=0.01)
    assert serve_loop.max_len(LONGDOC) == 7536     # 7,512 + 8 + 1, by 16


def test_every_client_sends_every_size_each_round_alike_for_all_seeds():
    sizes = serve_loop.prompt_lengths(LONGDOC)
    clients = int(LONGDOC["clients"])
    firsts = []
    for c in range(clients):
        it = serve_loop.schedule(LONGDOC, c)
        rounds = [[next(it) for _ in sizes] for _ in range(3)]
        assert all(sorted(r) == sizes for r in rounds)
        assert rounds[0] == rounds[1] == rounds[2]
        # consecutive sizes lie at least four strata apart
        rank = [sizes.index(n) for n in rounds[0] + rounds[0][:1]]
        assert min(abs(a - b) for a, b in zip(rank, rank[1:])) >= 4
        firsts.append(rounds[0][0])
    assert len(set(firsts)) == clients      # evenly spaced starts


def test_prompts_repeat_by_seed():
    a = serve_loop.prompt(9, "client3", 4, 600, 32256)
    assert a == serve_loop.prompt(9, "client3", 4, 600, 32256)
    assert a != serve_loop.prompt(10, "client3", 4, 600, 32256)
    assert min(a) >= serve_loop.RESERVED_IDS and max(a) < 32256


def test_closed_loop_hands_each_client_its_next_when_done():
    arr = serve_loop.Arrivals(LONGDOC, 0.0)
    first = arr.take(0.0)
    assert [d[1] for d in first] == [f"client{c}" for c in range(8)]
    assert arr.take(5.0) == []
    arr.done("client3", 2.5)
    (due, stream, k, n), = arr.take(2.5)
    assert (due, stream, k) == (2.5, "client3", 1)
    it = serve_loop.schedule(LONGDOC, 3)
    assert [next(it), next(it)] == [first[3][3], n]


def test_tweets_and_table_repeat_by_seed():
    seed = stream_seed(2**31 + 7, "records")
    a = list(tweets.TweetStream(seed, 100).frames(250))
    b = list(tweets.TweetStream(seed, 100).frames(250))
    assert a == b and [len(f) for f in a] == [100, 100, 50]
    t1, t2 = tweets.sensitive_words(3), tweets.sensitive_words(3)
    assert all(np.array_equal(t1[k], t2[k]) for k in t1)
    assert len(t1["key"]) == tweets.SENSITIVE_WORDS == 10_000


def test_feed_cells_state_their_batches():
    for name, rows in (("train.olmoe-1b-7b.feed", 4),
                       ("train.deepseek-coder-33b.feed", 2)):
        tr = load_cell(name).traffic
        assert (tr["rows"], tr["seq"], tr["frame_size"],
                tr["partitions"], tr["safety_filter"]) == (
                    rows, 4096, 6720, 2, True)
