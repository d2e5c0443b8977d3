"""The kernels' build and load under threads (kernels/match_cuda.py): a
session that warms on a second thread can reach a kernel's first build
at the same time as the main thread. No nvcc is needed: a stub compiler
copies the source to its output, and the library load is stubbed."""
import os
import stat
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from slam_toolbox_tpu_torch.kernels import match_cuda as mc

THREADS = 8


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A private build directory and a stub nvcc that copies its source
    (the last argument) to its -o output after a pause, so builds that
    start together overlap."""
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        '  case "$1" in -o) out="$2"; shift 2;; *) src="$1"; shift;; esac\n'
        "done\n"
        "sleep 0.2\n"
        'cp "$src" "$out"\n'
    )
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    out = tmp_path / "build"
    monkeypatch.setattr(mc, "BUILD_DIR", str(out))
    monkeypatch.setattr(mc, "_nvcc", lambda: str(stub))
    return out


def _run_threads(fn):
    """fn() on THREADS threads released together; returns their results
    in thread order and re-raises the first error."""
    barrier = threading.Barrier(THREADS)
    results, errors = [None] * THREADS, []

    def work(k):
        barrier.wait(timeout=30)
        try:
            results[k] = fn()
        except Exception as e:   # reported to the test below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    if errors:
        raise errors[0]
    return results


def test_concurrent_builds_leave_one_library(build_dir):
    """Threads compiling the same kernel at once write temporary files of
    their own and replace the library atomically: one library, the
    compiler's output, and no temporary file left behind."""
    _run_threads(lambda: mc.build_kernels(("score_windows",), force=True))
    assert sorted(os.listdir(build_dir)) == [
        "libscore_windows.so", "score_windows.log"]
    with open(build_dir / "libscore_windows.so") as f, \
            open(mc._source("score_windows")) as g:
        assert f.read() == g.read()


def test_first_use_builds_and_loads_once(build_dir, monkeypatch):
    """Threads that reach a kernel first at the same time share one build
    and one loaded library."""
    builds = []
    real_build = mc.build_kernels

    def counting_build(names, force=False):
        builds.append(tuple(names))
        return real_build(names, force=force)

    def fake_cdll(path):
        assert os.path.exists(path)
        return SimpleNamespace(score_windows=SimpleNamespace(),
                               score_windows_head=SimpleNamespace())

    monkeypatch.setattr(mc, "build_kernels", counting_build)
    monkeypatch.setattr(mc.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(mc, "_libs", {})
    libs = _run_threads(lambda: mc._lib("score_windows"))
    assert builds == [("score_windows",)]
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].score_windows.restype is not None
    assert libs[0].score_windows_head.restype is not None


def test_uncounted_launches_are_per_thread(monkeypatch):
    """Launches inside uncounted() (warming) are not counted; another
    thread's launches meanwhile are."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    mc.reset_launch_counts()
    inside = threading.Event()
    release = threading.Event()

    def warm():
        with mc.uncounted():
            mc._count("smear_quantize", 561)
            inside.set()
            release.wait(timeout=30)
            mc._count("smear_quantize", 561)

    t = threading.Thread(target=warm)
    t.start()
    try:
        assert inside.wait(timeout=30)
        mc._count("smear_quantize", 2051)   # counted: not the warm thread
    finally:
        release.set()
        t.join(timeout=30)
    assert not t.is_alive()
    mc._count("smear_quantize", 561)        # counted: the scope has ended
    assert mc.LAUNCHES["smear_quantize"] == 2
    assert dict(mc.GRID_LAUNCHES) == {("smear_quantize", 2051): 1,
                                      ("smear_quantize", 561): 1}
    mc.reset_launch_counts()
