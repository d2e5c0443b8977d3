"""core/laser_utils.py of the port against the JAX package's: the laser
auto-configuration from a live scan and a mounting transform
(LaserAssistant::makeLaser / isInverted, ScanHolder;
laser_utils.cpp:96-206), following tests/test_laser_utils.py. Inputs are
drawn from a numpy seed and go through both packages; every field must be
equal (tolerance 0: the code is the same NumPy in f64)."""
import dataclasses

import numpy as np
import pytest

from slam_toolbox_tpu.core import laser_utils as jlu
from slam_toolbox_tpu_torch.core import laser_utils as tlu


def _raw(mod, n=360, closed=False, ranges=None, frame_id="laser"):
    inc = 2.0 * np.pi / n
    nb = n + 1 if closed else n
    return mod.RawScan(
        angle_min=-np.pi, angle_max=np.pi, angle_increment=inc,
        range_min=0.2, range_max=30.0,
        ranges=np.full(nb, 5.0) if ranges is None else ranges,
        frame_id=frame_id,
    )


def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    T = np.eye(4)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    T[i, i], T[i, j], T[j, i], T[j, j] = c, -s, s, c
    return T


def _mounts(seed=0, n=12):
    """Random base->laser transforms: a yaw, a roll or pitch (some past 90
    degrees, so inverted), a translation with z in [-3, 1]."""
    rng = np.random.default_rng(seed)
    out = [np.eye(4), _rot(0, np.pi)]
    for _ in range(n):
        T = _rot(2, rng.uniform(-np.pi, np.pi)) @ _rot(
            int(rng.integers(0, 2)), rng.uniform(-np.pi, np.pi))
        T[:3, 3] = rng.uniform([-0.5, -0.5, -3.0], [0.5, 0.5, 1.0])
        out.append(T)
    return out


def _laser_fields(laser):
    return dataclasses.asdict(laser)


def test_mounting_and_inversion_match_jax():
    """mounting_from_transform (R, t, yaw) and is_inverted on 14 mounts,
    inverted and upright both present."""
    flags = []
    for T in _mounts():
        for a, b in zip(jlu.mounting_from_transform(T),
                        tlu.mounting_from_transform(T)):
            np.testing.assert_array_equal(a, b)
        flags.append(tlu.is_inverted(T))
        assert flags[-1] == jlu.is_inverted(T)
    assert any(flags) and not all(flags)


@pytest.mark.parametrize("closed", [False, True], ids=["360", "closed_360"])
@pytest.mark.parametrize("max_range", [20.0, -1.0, 99.0],
                         ids=["inside", "negative", "beyond"])
def test_make_laser_matches_jax(closed, max_range):
    """make_laser's LaserConfig (offset, 360 detection, threshold clamp)
    and its warnings, for every mount."""
    for T in _mounts(seed=1, n=4):
        jw, tw = [], []
        ref = jlu.make_laser(_raw(jlu, closed=closed), T, max_range,
                             warn=jw.append)
        got = tlu.make_laser(_raw(tlu, closed=closed), T, max_range,
                             warn=tw.append)
        assert _laser_fields(got) == _laser_fields(ref)
        assert tw == jw
        assert got.is_360 == (not closed)
        assert got.n_beams == ref.n_beams


def test_invert_and_metadata_match_jax():
    """invert_scan, to_laser_metadata and LaserMetadata.correct on seeded
    ranges, for upright and inverted mounts."""
    rng = np.random.default_rng(2)
    r = rng.uniform(0.1, 30.0, 361)
    np.testing.assert_array_equal(tlu.invert_scan(r), jlu.invert_scan(r))
    np.testing.assert_array_equal(tlu.invert_scan(r), r[::-1])
    for T in _mounts(seed=3, n=6):
        ref = jlu.to_laser_metadata(_raw(jlu), T, 25.0)
        got = tlu.to_laser_metadata(_raw(tlu), T, 25.0)
        assert got.inverted == ref.inverted
        assert _laser_fields(got.laser) == _laser_fields(ref.laser)
        np.testing.assert_array_equal(got.correct(r), ref.correct(r))


def test_scan_holder_matches_jax():
    """ScanHolder hands back beam-corrected copies for inverted mounts and
    the stored scan otherwise, as the JAX one does."""
    rng = np.random.default_rng(4)
    holders = {}
    for mod in (jlu, tlu):
        lasers = {
            "up": mod.to_laser_metadata(_raw(mod), np.eye(4)),
            "down": mod.to_laser_metadata(_raw(mod), _rot(0, np.pi)),
        }
        holders[mod] = mod.ScanHolder(lasers=lasers)
    frames = ["up", "down", "down", "up", "down"]
    for k, frame in enumerate(frames):
        r = rng.uniform(0.2, 30.0, 360)
        for mod, h in holders.items():
            h.add_scan(_raw(mod, ranges=r.copy(), frame_id=frame))
    assert len(holders[tlu]) == len(holders[jlu]) == len(frames)
    for k, frame in enumerate(frames):
        got = holders[tlu].get_corrected_scan(k)
        ref = holders[jlu].get_corrected_scan(k)
        np.testing.assert_array_equal(got.ranges, ref.ranges)
        assert (got.frame_id, got.time) == (ref.frame_id, ref.time)
        stored = holders[tlu]._scans[k].ranges
        if frame == "down":
            np.testing.assert_array_equal(got.ranges, stored[::-1])
        else:
            assert got is holders[tlu]._scans[k]
