"""The readers of the host solve's split (bench_port/metrics/
solve_assemble_ms.py, solve_cholesky_ms.py): ms a scan of their spans'
seconds, and nothing where the program has no such span, as a program
without the native assembly's spans has none."""
import pytest

from bench_port import harness


def test_assembly_reads_its_span():
    read = harness.metric_reader("solve_assemble_ms")
    assert read({"stats_s": {"solve_assemble": 0.5, "solve_lm": 2.0},
                 "scans": 250}) == pytest.approx(2.0)
    assert read({"stats_s": {"solve_lm": 2.0}, "scans": 250}) is None
    assert read({"scans": 250}) is None
    assert read({"stats_s": {"solve_assemble": 0.5}, "scans": 0}) is None


def test_cholesky_sums_analysis_and_factor():
    read = harness.metric_reader("solve_cholesky_ms")
    assert read({"stats_s": {"solve_analyze": 0.25, "solve_factor": 0.5,
                             "solve_assemble": 9.0}, "scans": 250}) \
        == pytest.approx(3.0)
    assert read({"stats_s": {"solve_factor": 0.5}, "scans": 250}) \
        == pytest.approx(2.0)
    assert read({"stats_s": {"solve_lm": 2.0, "solve_pack": 0.1},
                 "scans": 250}) is None
    assert read({"scans": 250}) is None
    assert read({"stats_s": {"solve_factor": 0.5}, "scans": 0}) is None
