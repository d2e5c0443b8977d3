"""The distributed solve in f64 against the JAX package's (under
jax.enable_x64 as a context) at 1, 2 and 4 ranks; the checks and
tolerances are test_torch_dist.py's."""
import pytest

from test_torch_dist import check_solve


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_distributed_solve_f64_matches_jax(tmp_path, n_dev):
    check_solve(tmp_path, n_dev, "f64", True)
