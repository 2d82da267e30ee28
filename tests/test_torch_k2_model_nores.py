"""K2's blocked form modelled block by block on the 13x41x67 grid, for the
step without the residual (``_torch_kernel_models.cheb_blocked_model``
against ``cheb_smooth_plain``; the step with it is in
tests/test_torch_k2_model_res.py)."""

import pytest

from _torch_kernel_models import check_k2_blocked_model


@pytest.mark.parametrize("grid", [(13, 41, 67)], ids=["13x41x67"])
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("want_res", [False], ids=["no-res"])
def test_k2_blocked_model_matches_plain(grid, degree, want_res):
    check_k2_blocked_model(grid, degree, want_res)
