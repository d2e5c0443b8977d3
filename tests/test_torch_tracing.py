"""The port's span recorder (slam_toolbox_tpu_torch/utils/metrics.py) on
the CPU: spans nest under the innermost open span of their thread, self
seconds add up to the roots' durations, the inclusive per-stage seconds
are the log's durations, a disabled Stats touches nothing, an exception
unwinds the stack, the ring counts what it overwrote, and a streaming
session's spans (one lap and back of the rooms world, 0.05 m grid, 361
beams, drains of 16 scans) nest as the drain's commit runs them, with
settle()'s commits under commit_total; a lifelong session's decay spans
nest under the commit, its parts under the decay and each removal under
the part that made it, each span's self seconds and its children's
seconds summing to its own; the decay counts the rows of its batched
passes (its reading-overlap rows are the filtered candidates that reach
the objective score, counted apart with the scalar metrics), and a
session without the decay counts none."""
import collections

import numpy as np
import pytest
import torch

from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.core.params import MapperConfig
from slam_toolbox_tpu_torch.core.scan import LaserConfig
from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu_torch.mapper import lifelong, streaming
from slam_toolbox_tpu_torch.mapper.lifelong import LifelongConfig
from slam_toolbox_tpu_torch.utils import metrics
from slam_toolbox_tpu_torch.utils.metrics import SpanLog, Stats, stage_timer

LAP = [(-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
       (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0), (-6.0, -3.5),
       (-1.0, -3.5)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    """A perf_counter stand-in that advances by `step` a reading."""

    def __init__(self, step=1.0):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.fixture
def log(monkeypatch):
    """A fresh span log of 64 slots and a scripted clock."""
    lg = SpanLog(64)
    monkeypatch.setattr(metrics, "SPANS", lg)
    monkeypatch.setattr(metrics, "_clock", Clock())
    return lg


def _by_index(w):
    return {int(i): k for k, i in enumerate(w["index"])}


def _name(w, k):
    return w["names"][w["name"][k]]


def _cfg_laser(**kw):
    """The sessions' mapper config (`kw` changed) and laser."""
    laser = LaserConfig(min_range=0.05, max_range=12.0, range_threshold=10.0,
                        angular_resolution=np.deg2rad(1.0))
    cfg = MapperConfig(
        minimum_travel_distance=0.2, minimum_time_interval=3600.0,
        scan_buffer_size=10, link_match_minimum_response_fine=0.1,
        link_scan_maximum_distance=1.5, loop_search_maximum_distance=3.0,
        loop_match_minimum_response_coarse=0.35,
        loop_match_minimum_response_fine=0.45,
        loop_match_maximum_variance_coarse=3.0,
        correlation_search_space_dimension=0.5,
        correlation_search_space_resolution=0.05,
        correlation_search_space_smear_deviation=0.1,
        distance_variance_penalty=0.5, angle_variance_penalty=1.0, **kw)
    return cfg, laser


@pytest.fixture(scope="module")
def session_spans():
    """A streaming session over 85 scans with its Stats on, flushed and
    closed; its spans from the process's log, its Stats and the number
    of times the pipeline ran its commit."""
    cfg, laser = _cfg_laser()
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.015, 0.006),
                         seed=42)
    data = sim.simulate(np.array(LAP), step=0.55)
    commits = []
    mp = pytest.MonkeyPatch()
    plain = streaming.StreamingPipeline._commit_impl

    def counted(self):
        commits.append(1)
        return plain(self)

    mp.setattr(streaming.StreamingPipeline, "_commit_impl", counted)
    try:
        sess = SlamSession(cfg, laser, device="cpu", streaming=True,
                           drain_every=16)
        sess.stats.enabled = True
        t0 = metrics._clock()
        for i, (scan, _) in enumerate(data):
            sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        sess.flush()
        stats = sess.stats
        sess.close()
        t1 = metrics._clock()
    finally:
        mp.undo()
    return dict(w=metrics.SPANS.window(t0, t1), stats=stats,
                commits=len(commits), scans=len(data))


def test_session_spans_nest_as_the_commit_runs_them(session_spans):
    w = session_spans["w"]
    assert w is not None and len(w["index"]) > session_spans["scans"]
    at = _by_index(w)
    chains = collections.Counter()
    for k in range(len(w["index"])):
        chain, j = [], k
        while j is not None:
            chain.append(_name(w, j))
            p = int(w["parent"][j])
            j = at[p] if p >= 0 else None
        chains[tuple(chain)] += 1
    assert chains[("find_near_chains", "graph_edges", "commit_bookkeep",
                   "commit_total", "process_scan")] > 0
    assert chains[("find_near_chains", "graph_edges", "commit_bookkeep",
                   "commit_total", "flush")] > 0
    assert chains[("link_chain_to_scan", "graph_edges", "commit_bookkeep",
                   "commit_total", "process_scan")] > 0
    assert chains[("drain_fetch", "commit_total", "process_scan")] > 0
    # every root is a call into the session, and one a process_scan call
    roots = collections.Counter(chain[-1] for chain in chains.elements())
    assert set(roots) <= {"process_scan", "flush", "close"}
    assert sum(1 for k in range(len(w["index"]))
               if w["parent"][k] < 0 and _name(w, k) == "process_scan") \
        == session_spans["scans"]
    # a span's root is its outermost ancestor
    for k in range(len(w["index"])):
        j = k
        while w["parent"][j] >= 0:
            j = at[int(w["parent"][j])]
        assert w["root"][k] == w["index"][j]
    # the closures' solves: solve_pack and solve_lm under solve
    assert session_spans["stats"].counts["solve"] > 0
    for k in range(len(w["index"])):
        if _name(w, k) in ("solve_pack", "solve_lm"):
            assert _name(w, at[int(w["parent"][k])]) == "solve"


def test_self_seconds_sum_to_the_roots_durations(session_spans):
    w = session_spans["w"]
    dur = w["t1"] - w["t0"]
    roots = w["parent"] < 0
    n = len(dur)
    assert abs(w["self"].sum() - dur[roots].sum()) <= 1e-9 * n
    assert (w["self"] >= -1e-9).all()
    st = session_spans["stats"]
    assert abs(sum(st.self_seconds.values()) - dur[roots].sum()) <= 1e-9 * n
    # solve's self time is what solve_pack and solve_lm leave
    assert st.self_seconds["solve"] == pytest.approx(
        st.seconds["solve"] - st.seconds["solve_pack"]
        - st.seconds["solve_lm"], abs=1e-9 * n)


@pytest.mark.parametrize("stage", ["commit_bookkeep", "graph_edges", "solve",
                                   "find_near_chains", "link_chain_to_scan",
                                   "solve_pack", "solve_analyze",
                                   "solve_assemble", "solve_factor"])
def test_inclusive_seconds_are_the_logs_durations(session_spans, stage):
    w = session_spans["w"]
    st = session_spans["stats"]
    nid = w["names"].index(stage)
    mine = w["name"] == nid
    assert st.counts[stage] == int(mine.sum()) > 0
    assert st.seconds[stage] == pytest.approx(
        float((w["t1"] - w["t0"])[mine].sum()), abs=1e-9 * int(mine.sum()))
    assert st.self_seconds[stage] == pytest.approx(
        float(w["self"][mine].sum()), abs=1e-9 * int(mine.sum()))


def test_the_host_solve_splits_solve_lm(session_spans):
    """host_sparse_lm's analysis, native assembly passes and factor-solves
    are spans under solve_lm: one analysis a solve, an assembly for the
    first chi2 and one more for each step's blocks and for its chi2, a
    factor-solve a step."""
    w = session_spans["w"]
    at = _by_index(w)
    kids = collections.defaultdict(collections.Counter)
    for k in range(len(w["index"])):
        name = _name(w, k)
        if name in ("solve_analyze", "solve_assemble", "solve_factor"):
            p = at[int(w["parent"][k])]
            assert _name(w, p) == "solve_lm"
            kids[p][name] += 1
    lms = [k for k in range(len(w["index"])) if _name(w, k) == "solve_lm"]
    assert lms and set(kids) == set(lms)
    for k in lms:
        c = kids[k]
        assert c["solve_analyze"] == 1
        assert c["solve_assemble"] >= 2
        assert c["solve_assemble"] in (2 * c["solve_factor"] + 1,
                                       2 * c["solve_factor"] + 2)


def test_settles_commits_fall_under_commit_total(session_spans):
    """Every commit, drain()'s and settle()'s (under flush), is one
    commit_total span, so commit_bookkeep never reads above it."""
    w = session_spans["w"]
    st = session_spans["stats"]
    assert st.counts["commit_total"] == session_spans["commits"]
    at = _by_index(w)
    parents = collections.Counter(
        _name(w, at[int(w["parent"][k])]) for k in range(len(w["index"]))
        if _name(w, k) == "commit_total")
    assert parents["flush"] >= 1 and parents["process_scan"] >= 1
    assert st.seconds["commit_bookkeep"] <= st.seconds["commit_total"]


def test_a_disabled_stats_touches_neither_log_nor_stack(log):
    off = Stats(enabled=False)
    with stage_timer(off, "a"):
        assert metrics._STACK.open == []
        with stage_timer(None, "b"):
            assert metrics._STACK.open == []
    assert metrics._clock.t == 0.0          # no clock read
    assert log._written == 0 and log.window(-1.0, 1e9)["index"].size == 0
    assert not off.counts and not off.seconds and not off.self_seconds


def test_a_span_without_stats_charges_the_enclosing_ones(log):
    outer, inner = Stats(), Stats()
    with stage_timer(None, "lost"):         # nothing open: nothing kept
        pass
    assert log._written == 0 and metrics._clock.t == 0.0
    with stage_timer(outer, "a"):           # clock 1
        with stage_timer(inner, "b"):       # clock 2
            with stage_timer(None, "c"):    # clock 3, 4
                pass
        # clock 5 closes b
    # clock 6 closes a
    assert dict(inner.seconds) == {"b": 3.0, "c": 1.0}
    assert dict(inner.self_seconds) == {"b": 2.0, "c": 1.0}
    assert dict(outer.seconds) == {"a": 5.0}
    assert dict(outer.self_seconds) == {"a": 2.0}
    w = log.window(0.0, 10.0)
    assert [_name(w, k) for k in range(3)] == ["a", "b", "c"]
    assert list(w["parent"]) == [-1, w["index"][0], w["index"][1]]
    assert list(w["root"]) == [w["index"][0]] * 3
    assert list(w["t0"]) == [1.0, 2.0, 3.0]
    assert list(w["t1"]) == [6.0, 5.0, 4.0]


def test_an_exception_closes_the_span_and_unwinds_the_stack(log):
    st = Stats()
    with pytest.raises(KeyError):
        with stage_timer(st, "a"):
            with stage_timer(st, "b"):
                raise KeyError("x")
    assert metrics._STACK.open == []
    assert st.counts == {"a": 1, "b": 1}
    # a span whose inner span was never closed unwinds past it
    a = stage_timer(st, "a")
    a.__enter__()
    stage_timer(st, "b").__enter__()
    a.__exit__(None, None, None)
    assert metrics._STACK.open == []
    with stage_timer(st, "c"):
        assert [s.stage for s in metrics._STACK.open] == ["c"]
    w = log.window(0.0, 100.0)
    assert w["parent"][-1] == -1            # c is a root again


def test_the_ring_overwrites_its_oldest_and_says_so(monkeypatch):
    lg = SpanLog(8)
    monkeypatch.setattr(metrics, "SPANS", lg)
    monkeypatch.setattr(metrics, "_clock", Clock())
    st = Stats()
    for _ in range(5):
        with stage_timer(st, "a"):
            pass
    assert lg.lost() == 0
    w = lg.window(0.0, 100.0)
    assert len(w["index"]) == 5 and list(w["t0"]) == [1, 3, 5, 7, 9]
    for _ in range(7):
        with stage_timer(st, "a"):
            pass
    assert lg.lost() == 4 and lg._written == 12
    w = lg.window(9.0, 100.0)               # the oldest held opened at 9
    assert len(w["index"]) == 8
    assert list(np.diff(w["index"])) == [1] * 7
    assert list(w["t0"]) == [float(t) for t in range(9, 25, 2)]
    assert lg.window(8.5, 100.0) is None    # the span opened at 7 is gone
    with pytest.raises(ValueError):
        SpanLog(6)


def _reaching_the_score(ll, scan) -> int:
    """The candidates of the decay of `scan` that reach objective_score,
    counted with the scalar metrics before the decay runs: linked within
    half the scan's box diagonal, an IOU of iou_thresh or more, 2
    constraints or more, outside the buffer's ids and ids 0 and 1."""
    m = ll.mapper
    bb = scan.bounding_box
    radius = float(np.hypot(*(bb[1] - bb[0])) / 2.0)
    buf = m.config.scan_buffer_size
    n = 0
    for c in m.graph.find_near_linked_scans(scan, radius):
        if (c is scan or lifelong.iou(scan, c) < ll.cfg.iou_thresh
                or len(m.graph.adjacency.get(c.unique_id, [])) < 2):
            continue
        n += scan.unique_id - c.unique_id >= buf and c.unique_id > 1
    return n


@pytest.fixture(scope="module")
def lifelong_spans():
    """A lifelong streaming session over two laps and back (the top-up
    at 12 candidates, removals marginalized, chains of 6: the setting of
    test_torch_lifelong.py), Stats on; its spans, its Stats and the
    candidates that reached the objective score, counted apart."""
    cfg, laser = _cfg_laser(loop_match_minimum_chain_size=6,
                            marginalize_on_removal=True)
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.015, 0.006),
                         seed=42)
    data = sim.simulate(np.array(LAP * 2), step=0.5)
    sess = SlamSession(cfg, laser, device="cpu", streaming=True,
                       drain_every=16,
                       lifelong=LifelongConfig(steady_state_min_candidates=12))
    sess.stats.enabled = True
    ll = sess.lifelong
    evaluate = ll.evaluate_node_depreciation
    reach = []

    def counted(scan):
        reach.append(_reaching_the_score(ll, scan))
        return evaluate(scan)

    ll.evaluate_node_depreciation = counted
    t0 = metrics._clock()
    for i, (scan, _) in enumerate(data):
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
    sess.flush()
    stats = sess.stats
    t1 = metrics._clock()
    sess.close()
    return dict(w=metrics.SPANS.window(t0, t1), stats=stats,
                reach=sum(reach), evals=len(reach))


DECAY_PARTS = ("decay_query", "decay_filter", "decay_score", "decay_topup")


def test_the_decay_nests_under_the_commit(lifelong_spans):
    w = lifelong_spans["w"]
    st = lifelong_spans["stats"]
    at = _by_index(w)
    parent = {}
    for k in range(len(w["index"])):
        p = int(w["parent"][k])
        parent[k] = _name(w, at[p]) if p >= 0 else None
    names = collections.Counter(_name(w, k) for k in parent)
    assert names["decay"] == st.counts["decay_evals"] > 0
    assert st.counts["decay_removed"] == names["decay_remove"] >= 20
    assert 0 < st.counts["decay_forced"] <= st.counts["decay_removed"]
    assert st.counts["decay_candidates"] > 0
    for k, p in parent.items():
        name = _name(w, k)
        if name == "decay":
            assert p == "commit_bookkeep"
        elif name in DECAY_PARTS:
            assert p == "decay"
        elif name == "decay_remove":
            assert p in ("decay_score", "decay_topup")
    assert names["decay_query"] == names["decay_filter"] == names["decay"]
    assert names["decay_score"] == names["decay_topup"] == names["decay"]


def test_a_decay_spans_self_and_children_sum_to_it(lifelong_spans):
    w = lifelong_spans["w"]
    at = _by_index(w)
    dur = w["t1"] - w["t0"]
    kids = collections.defaultdict(float)
    for k in range(len(w["index"])):
        p = int(w["parent"][k])
        if p >= 0:
            kids[at[p]] += dur[k]
    seen = 0
    for k in range(len(w["index"])):
        if _name(w, k).startswith("decay"):
            assert w["self"][k] == pytest.approx(dur[k] - kids[k],
                                                 abs=1e-12)
            assert w["self"][k] >= -1e-12
            seen += 1
    assert seen > 0
    st = lifelong_spans["stats"]
    n = st.counts["decay_remove"] + 5 * st.counts["decay"]
    assert st.seconds["decay"] == pytest.approx(
        st.self_seconds["decay"] + sum(st.seconds[p] for p in DECAY_PARTS),
        abs=1e-9 * n)
    assert (st.seconds["decay_score"] - st.self_seconds["decay_score"]
            + st.seconds["decay_topup"] - st.self_seconds["decay_topup"]
            ) == pytest.approx(st.seconds["decay_remove"], abs=1e-9 * n)


BATCH_COUNTERS = ("decay_batch_rows", "decay_overlap_rows",
                  "decay_points_packed")


def test_the_decay_counts_its_batched_rows(lifelong_spans):
    """A lifelong session counts rows through the batched IOU pass (at
    least the filtered candidates), through the reading-overlap pass
    (exactly the filtered candidates that reach the objective score) and
    nodes packed into the points store."""
    st = lifelong_spans["stats"]
    for k in BATCH_COUNTERS:
        assert st.counts.get(k, 0) > 0, k
    assert lifelong_spans["evals"] == st.counts["decay_evals"]
    assert st.counts["decay_overlap_rows"] == lifelong_spans["reach"]
    assert st.counts["decay_batch_rows"] >= st.counts["decay_candidates"]
    # each node packed once at most, and every node was a decayed scan
    assert st.counts["decay_points_packed"] <= st.counts["decay_evals"]


def test_a_session_without_the_decay_counts_no_rows(session_spans):
    counts = session_spans["stats"].counts
    for k in BATCH_COUNTERS + ("decay_box_refresh",):
        assert k not in counts, k
