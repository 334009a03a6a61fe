"""The reference's judge: exact rows, order, ties at the k-th distance,
V.R at its boundary; the relabelling check; the trace's interval
arithmetic."""
import numpy as np

from perfbench.harness import physical_to_logical
from perfbench.reference import bruteforce as bf
from perfbench.reference import controls
from perfbench.trace import _innermost, _merge


def _table(n=400, d=8, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    return x, {"price": r.uniform(0, 100, n).astype(np.float32)}


def test_sq_dists_is_the_systems_law_row_by_row():
    x, _ = _table(5000, 33)
    v = x[7]
    got = bf.sq_dists(x, v)
    want = np.array([np.sum((x[i] - v) ** 2) for i in range(len(x))],
                    np.float32)
    assert np.array_equal(got, want)
    assert got[7] == 0


def test_vk_answer_and_its_faults():
    x, num = _table()
    q = {"vec": x[3], "nr": [], "vr": None, "vk": 10}
    d2 = bf.sq_dists(x, q["vec"])
    right = bf.evaluate(q, d2, num)
    assert right[0] == 3 and bf.judge(q, d2, num, right, True) is None
    assert bf.judge(q, d2, num, right[::-1], True) == \
        "rows out of distance order"
    assert bf.judge(q, d2, num, right[::-1], False) is None
    wrong = right.copy()
    wrong[-1] = np.argsort(d2)[20]
    assert bf.judge(q, d2, num, wrong, True) is not None
    assert bf.judge(q, d2, num, right[:9], True) == "9 rows for 10"
    assert bf.judge(q, d2, num, np.r_[right[:9], right[0]], True) == \
        "a row repeats"


def test_rows_tied_at_the_kth_distance_stand_for_each_other():
    x, num = _table(50, 4)
    x[11] = x[10]                        # rows 10 and 11 tie everywhere
    q = {"vec": x[0], "nr": [], "vr": None}
    d2 = bf.sq_dists(x, q["vec"])
    order = np.lexsort((np.arange(50), d2))
    k = int(np.nonzero(order == 10)[0][0]) + 1   # row 10 is the k-th
    q["vk"] = k
    right = bf.evaluate(q, d2, num)
    swapped = np.where(right == 10, 11, right)
    assert bf.judge(q, d2, num, swapped, True) is None


def test_postfilter_and_range_sets():
    x, num = _table()
    d2 = bf.sq_dists(x, x[5])
    r = float(np.sqrt(np.sort(d2)[40]))
    vr = {"vec": x[5], "nr": [("price", 20.0, 80.0)], "vr": r, "vk": None}
    rows = bf.evaluate(vr, d2, num)
    assert bf.judge(vr, d2, num, rows[::-1], False) is None
    assert bf.judge(vr, d2, num, rows[1:], False) is not None
    edge = np.float32(r) ** 2
    d2b = d2.copy()
    d2b[rows[0]] = np.nextafter(np.float32(edge), np.float32(np.inf))
    assert bf.judge(vr, d2b, num, rows, False) is not None
    post = {"vec": x[5], "nr": [("price", 25.0, 75.0)], "vr": None, "vk": 8}
    rows = bf.evaluate(post, d2, num)
    assert np.all(np.diff(rows) > 0)
    assert bf.judge(post, d2, num, rows, False) is None
    assert num["price"][rows].min() >= 25


def test_relabelled_rows_are_caught():
    x, num = _table(100, 4)
    perm = np.random.default_rng(1).permutation(100)
    view = x[perm]
    vnum = {"price": num["price"][perm]}
    logical, same = physical_to_logical(perm, view, vnum, x, num,
                                        np.array([3, 9]))
    assert same and list(logical) == [perm[3], perm[9]]
    bad = perm.copy()
    bad[3] = perm[4]
    _, same = physical_to_logical(bad, view, vnum, x, num, np.array([3]))
    assert not same


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -11 + 2 ** -12)])
    got = controls.round_tf32(x).tolist()
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                   -(1.0 + 2 ** -10)]


def test_busy_time_and_gaps():
    busy, gaps = _merge([(2, 5), (4, 7), (9, 10)], 0, 12)
    assert busy == 6 and gaps == [(0, 2), (7, 9), (10, 12)]


def test_innermost_span():
    times, labels = _innermost([(0, 10, "poll"), (2, 4, "embed"),
                                (6, 8, "embed"), (12, 13, "plan")])
    at = dict(zip(times, labels))
    assert at[0] == "poll" and at[2] == "embed" and at[4] == "poll"
    assert at[8] == "poll" and at[10] == "other" and at[13] == "other"


def test_recorder_reads_the_part_before_the_profiler():
    """With a snapshot (the profiler started for the window's tail),
    counters, gauges and spans are read up to it; without, over all."""
    from perfbench.record import Recorder
    for snap in (False, True):
        served = [10.0]
        rec = Recorder()
        rec.gauge("served", lambda: served[0])
        rec.start_window()
        rec.count("rescued", 3)
        with rec.span("embed"):
            pass
        served[0] = 14.0
        if snap:
            rec.snapshot()
        rec.count("rescued", 5)
        with rec.span("embed"):
            pass
        served[0] = 30.0
        rec.end_window()
        s, counters, spans = rec.part()
        if snap:
            assert s <= rec.window_s and len(spans["embed"]) == 1
            assert counters == {"rescued": 3.0, "served": 4.0}
        else:
            assert s == rec.window_s and len(spans["embed"]) == 2
            assert counters == {"rescued": 8.0, "served": 20.0}
