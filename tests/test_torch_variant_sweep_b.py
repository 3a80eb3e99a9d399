"""The variant sweep's cases of group 1 (``test_torch_variant_sweep.py``)."""

import pytest

from test_torch_variant_sweep import GROUPS, check_case


@pytest.mark.parametrize("name", GROUPS[1])
def test_plain_walk_matches_reference(name):
    check_case(name)
