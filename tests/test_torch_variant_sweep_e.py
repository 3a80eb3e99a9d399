"""The variant sweep's cases of group 4 (``test_torch_variant_sweep.py``)."""

import pytest

from test_torch_variant_sweep import GROUPS, check_case


@pytest.mark.parametrize("name", GROUPS[4])
def test_plain_walk_matches_reference(name):
    check_case(name)
