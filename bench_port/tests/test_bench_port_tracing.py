"""The readers of the program's spans (bench_port/metrics/): each gives its
number on a hand-made record and span log, and nothing where the program
has no such span, the log lost the window's start or the run had no
trace; the idle attribution charges hand-placed idle stretches to the
innermost open span."""
import pytest

from bench_port import harness
from slam_toolbox_tpu_torch.utils import metrics
from slam_toolbox_tpu_torch.utils.metrics import SpanLog, Stats, stage_timer

STAGE_READERS = {"near_chains_ms": "find_near_chains",
                 "link_chain_ms": "link_chain_to_scan",
                 "solve_pack_ms": "solve_pack", "capture_ms": "capture"}


class Clock:
    """perf_counter's stand-in: returns the times it is given, in turn."""

    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def _log(monkeypatch, opens, capacity=64):
    """A span log holding `opens`: (name, t0, t1, children) trees, opened
    in turn on one thread and charged to one Stats."""
    lg = SpanLog(capacity)
    monkeypatch.setattr(metrics, "SPANS", lg)
    st = Stats()

    def times(tree):
        name, t0, t1, kids = tree
        return [t0] + [t for k in kids for t in times(k)] + [t1]

    def run(tree):
        name, _, _, kids = tree
        with stage_timer(st, name):
            for k in kids:
                run(k)

    for tree in opens:
        monkeypatch.setattr(metrics, "_clock", Clock(times(tree)))
        run(tree)
    return lg, st


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_a_stage_reader_gives_its_stage_ms_a_scan(name):
    read = harness.metric_reader(name)
    stage = STAGE_READERS[name]
    assert read({"stats_s": {stage: 0.5, "solve": 2.0}, "scans": 250}) \
        == pytest.approx(2.0)
    # a program that does not record the span gives nothing
    assert read({"stats_s": {"solve": 2.0}, "scans": 250}) is None
    assert read({"scans": 250}) is None
    assert read({"stats_s": {stage: 0.5}, "scans": 0}) is None


def test_device_wait_sums_the_three_waits():
    read = harness.metric_reader("device_wait_ms")
    s = {"process_scan": 9.0, "drain_fetch": 0.25, "near_chain_wait": 0.05,
         "loop_verify_wait": 0.2, "commit_total": 3.0}
    assert read({"stats_s": s, "scans": 100}) == pytest.approx(5.0)
    del s["near_chain_wait"]            # no miss a window: it adds nothing
    assert read({"stats_s": s, "scans": 100}) == pytest.approx(4.5)
    # the same stages from a program without root spans give nothing
    del s["process_scan"]
    assert read({"stats_s": s, "scans": 100}) is None


TREES = [
    ("process_scan", 1.0, 2.0, []),
    ("process_scan", 3.0, 9.0, [
        ("commit_total", 3.5, 8.0, [
            ("drain_fetch", 3.5, 4.0, []),
            ("commit_bookkeep", 4.0, 7.5, [
                ("graph_edges", 4.5, 5.0, [
                    ("find_near_chains", 4.6, 4.8, [])]),
                ("graph_edges", 6.0, 6.5, [])])])]),
    ("flush", 10.0, 12.0, [("commit_total", 10.5, 11.5, [
        ("commit_bookkeep", 10.5, 11.0, [])])]),
]


def test_commit_self_ms_reads_the_logs_self_time(monkeypatch):
    _log(monkeypatch, TREES)
    read = harness.metric_reader("commit_self_ms")
    # commit_bookkeep: 3.5 s less its children's 1.0, and 0.5: 3.0 s
    assert read({"t0": 0.0, "t1": 13.0, "scans": 3}) == pytest.approx(1e3)
    assert read({"t0": 9.5, "t1": 13.0, "scans": 1}) == pytest.approx(500.0)
    assert read({"t0": 0.0, "t1": 13.0, "scans": 0}) is None
    monkeypatch.delattr(metrics, "SPANS")    # a program with no span log
    assert read({"t0": 0.0, "t1": 13.0, "scans": 3}) is None


def test_a_reader_gives_nothing_where_the_log_lost_the_start(monkeypatch):
    lg, _ = _log(monkeypatch, TREES, capacity=8)
    assert lg.lost() == 3
    rec = {"t0": 0.0, "t1": 13.0, "scans": 3,
           "trace": [("k", 0.0, 0.5)]}
    for name in ("commit_self_ms", "unspanned_idle_share"):
        assert harness.metric_reader(name)(rec) is None
    # a window that starts where the ring still holds every span
    late = {"t0": 4.5, "t1": 13.0, "scans": 1, "trace": [("k", 4.5, 5.0)]}
    assert harness.metric_reader("commit_self_ms")(late) is not None


def test_idle_is_charged_to_the_innermost_open_span(monkeypatch):
    _log(monkeypatch, TREES)
    mod = harness.plugin("metrics", "unspanned_idle_share")
    w = metrics.SPANS.window(0.0, 13.0)
    gaps = [(0.5, 1.5), (3.2, 3.6), (4.55, 4.7), (5.5, 6.2), (8.5, 10.2),
            (11.8, 13.0)]
    got = mod.idle_by_program_span(gaps, w)
    want = {None: 0.5 + 1.0 + 1.0, "process_scan": 0.5 + 0.3 + 0.5,
            "commit_total": 0.0, "drain_fetch": 0.1,
            "graph_edges": 0.05 + 0.2, "find_near_chains": 0.1,
            "commit_bookkeep": 0.5, "flush": 0.2 + 0.2}
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(sum(b - a for a, b in gaps))
    # the device busy outside these gaps: the share no span covers
    rec = {"t0": 0.0, "t1": 13.0,
           "trace": [("k", a, b) for a, b in
                     zip([0.0] + [g[1] for g in gaps],
                         [g[0] for g in gaps] + [13.0]) if b > a]}
    share = harness.metric_reader("unspanned_idle_share")(rec)
    assert share == pytest.approx(100.0 * 2.5 / 5.15)
    # no trace (a CPU run), or a program without a span log: nothing
    assert harness.metric_reader("unspanned_idle_share")(
        {"t0": 0.0, "t1": 13.0}) is None
    monkeypatch.delattr(metrics, "SPANS")
    assert harness.metric_reader("unspanned_idle_share")(rec) is None


def test_innermost_cuts_a_span_that_outlasts_its_parent():
    import numpy as np

    mod = harness.plugin("metrics", "unspanned_idle_share")
    w = {"t0": np.array([0.0, 1.0, 5.0]), "t1": np.array([4.0, 6.0, 7.0]),
         "name": np.array([1, 2, 3]), "names": [None, "a", "b", "c"]}
    assert mod.innermost(w) == [(0.0, 1.0, 1), (1.0, 4.0, 2), (5.0, 7.0, 3)]
