"""The traffic a run offers is a function of --seed alone, and every seed
offers the same work in another order."""
import numpy as np

from bench import serve, train
from bench.tests import tiny


def test_schedule_repeats_for_a_seed():
    t = tiny.load("traffic", "mobile-2k")
    a1, u1 = serve.schedule(t, 2**33 + 7, 30.0)
    a2, u2 = serve.schedule(t, 2**33 + 7, 30.0)
    assert np.array_equal(a1, a2) and np.array_equal(u1, u2)
    p1 = serve.prompts(151936, 3, 2048, 2**33 + 7)
    assert np.array_equal(p1, serve.prompts(151936, 3, 2048, 2**33 + 7))


def test_seeds_offer_the_same_work_in_another_order():
    t = tiny.load("traffic", "mobile-2k")
    a1, u1 = serve.schedule(t, 11, 30.0)
    a2, u2 = serve.schedule(t, 12, 30.0)
    n = int(round(t["rate_per_s"] * 30.0))
    assert len(a1) == len(a2) == n
    assert np.allclose(np.sort(np.diff(np.r_[a1, 30.0])),
                       np.sort(np.diff(np.r_[a2, 30.0])))
    assert np.array_equal(np.sort(u1), np.sort(u2))
    assert not np.array_equal(u1, u2)
    assert a1[0] == 0.0 and a1[-1] < 30.0
    assert np.all(u1 >= t["network"]["floor_ms"])
    # the uplinks follow the paper's campus WiFi
    assert abs(np.mean(u1) - t["network"]["mean_ms"]) < 1.0
    assert abs(np.std(u1) - t["network"]["std_ms"]) < 2.0


def test_training_feed_repeats_and_rows_differ():
    f = train.Feed(50280, 2, 1024, 5)
    b0, b0again = f.batch_at(0), train.Feed(50280, 2, 1024, 5).batch_at(0)
    assert np.array_equal(b0["tokens"], b0again["tokens"])
    assert np.array_equal(b0["tokens"][:, 1:], b0["targets"][:, :-1])
    rows = np.concatenate([f.batch_at(s)["tokens"] for s in range(4)])
    assert len({r.tobytes() for r in rows}) == len(rows)
