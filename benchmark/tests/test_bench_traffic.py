"""The traffic generator: deterministic from the seed, the same videos and
lengths in another order for every seed."""

import itertools

import numpy as np

from benchmark import traffic
from benchmark.tests.tiny import MIX

DVC = {"frames": {"min": 96, "max": 200}, "pool_videos": 16, "pool_seed": 0,
       "queries": ["a", "b", "c"], "resolution": 8}


def _take(mix, seed, n):
    return list(itertools.islice(traffic.sessions(mix, seed), n))


def test_lengths_are_evenly_spaced():
    assert traffic.lengths(DVC) == [96 + round(104 * i / 15) for i in range(16)]
    assert traffic.lengths(DVC)[0] == 96 and traffic.lengths(DVC)[-1] == 200


def test_sessions_repeat_from_the_seed():
    seed = 2 ** 31 + 12345
    assert _take(DVC, seed, 50) == _take(DVC, seed, 50)
    assert _take(DVC, seed, 50) != _take(DVC, seed + 1, 50)


def test_every_cycle_holds_every_video_at_its_length():
    orders = set()
    for seed in (0, 7, 2 ** 33):
        got = _take(DVC, seed, 48)
        for c in range(3):
            cycle = got[16 * c:16 * (c + 1)]
            assert sorted(s.video for s in cycle) == list(range(16))
            orders.add(tuple(s.video for s in cycle))
        assert all(s.frames == traffic.lengths(DVC)[s.video] for s in got)
        assert [s.index for s in got] == list(range(48))
    assert len(orders) == 9


def test_pixel_pool_repeats_from_its_seed():
    a = traffic.pixel_pool(MIX, "cpu")
    b = traffic.pixel_pool(MIX, "cpu")
    c = traffic.pixel_pool(dict(MIX, pool_seed=1), "cpu")
    assert a.dtype == np.uint8
    assert a.shape == (MIX["pool_videos"], MIX["frames"]["max"], 32, 32, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # frames differ from one another: the content moves
    assert np.abs(a[0, 0].astype(int) - a[0, -1].astype(int)).mean() > 1.0
