"""The variant sweep's cases of group 6 (``test_torch_variant_sweep.py``):
the general rows builds."""

import pytest

from test_torch_variant_sweep import GROUPS, check_case


@pytest.mark.parametrize("name", GROUPS[6])
def test_plain_walk_matches_reference(name):
    check_case(name)
