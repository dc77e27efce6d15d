"""The port's cell-id decoder and discipline list
(repro_torch.scenarios.spec) against the reference's (repro.scenarios.spec).

* ``parse_cell_id`` over every cell id of every preset, full and
  ``--quick``: equal to the reference's, and ``cell_id`` of its items
  gives the id back (``"base"`` decodes to ``{}`` and back);
* ``POLICIES`` equals the reference's.
"""

import pytest

from repro.scenarios import presets as ref_presets
from repro.scenarios import spec as ref_spec
from repro_torch.scenarios import presets, spec


def test_policies_match_reference():
    assert spec.POLICIES == ref_spec.POLICIES


@pytest.mark.parametrize("name", ref_presets.list_presets())
@pytest.mark.parametrize("quick", [False, True])
def test_parse_cell_id_matches_reference_and_inverts_cell_id(name, quick):
    sweep = presets.get_preset(name)
    if quick:
        sweep = presets.quick_sweep(sweep)
    cids = [cid for cid, _ in sweep.expand()] + ["base"]
    for cid in cids:
        got = spec.parse_cell_id(cid)
        assert got == ref_spec.parse_cell_id(cid)
        assert spec.cell_id(tuple(got.items())) == cid
