"""The knee is the highest rate up to which every rate of the sweep
keeps its attainment within 0.05 of the lowest rate's and no backlog
grows, and each serve mix's committed rate and t_sla follow from its
committed sweep record."""
import json
from pathlib import Path

from bench import sweep

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def row(rate, att, n=60, mid=0, end=0):
    return dict(rate=rate, attainment=att, n=n, backlog_mid=mid,
                backlog_end=end)


def test_the_knee_is_the_last_rate_before_the_first_that_fails():
    rows = [row(1, 0.96), row(1.5, 0.93), row(2, 0.90), row(2.5, 0.95)]
    assert sweep.knee_of(rows) == 1.5          # 2 fails; 2.5 comes too late
    assert sweep.knee_of(rows[:2] + [row(2, 0.95, mid=1, end=3)]) == 1.5


def test_no_knee_without_a_failing_rate_or_enough_requests():
    assert sweep.knee_of([row(1, 0.96), row(2, 0.95)]) is None
    assert sweep.knee_of([row(1, 0.96, n=10), row(2, 0.80)]) is None


def test_four_fifths_rounded_down():
    assert sweep.rate_at(1.5) == 1.2
    assert sweep.rate_at(2.0) == 1.6
    assert sweep.rate_at(10.0) == 8.0


def test_committed_rates_follow_from_their_sweeps():
    records = sorted(TRAFFIC.glob("*.sweep.json"))
    assert records
    for rec_path in records:
        rec = json.loads(rec_path.read_text())
        mix = json.loads(rec_path.with_name(
            rec_path.name.replace(".sweep.json", ".json")).read_text())
        knee = sweep.knee_of(rec["rows"])
        assert knee is not None and knee == rec["knee"], rec_path.name
        assert mix["rate_per_s"] == sweep.rate_at(knee), rec_path.name
        assert mix["t_sla_ms"] == rec["t_sla_ms"], rec_path.name
