"""The per-cell patch path at 33^3 against mfmg_tpu on the CPU:
``_super_blocks_per_cell`` (chunked over cells) on the inputs of the
reference's own 4-level float64 Q1 hierarchy at 33^3, level 1 (8
super-agglomerates, the path a light level-0 batch takes) in one chunk and
level 2 in several; A1 and the Gram to 1e-12 of their largest entry, the
member tables exactly.  The 17^3 cases are in tests/test_torch_deep.py.
"""

import pytest

import mfmg_torch.amge.multilevel as tml

from _torch_deep import check_super_blocks


@pytest.mark.parametrize("n_ref,level,chunk_bytes", [
    (5, 1, tml.CELL_CHUNK_BYTES), (5, 2, 1 << 22)],
    ids=["33^3-L1", "33^3-L2-chunks"])
def test_super_blocks_per_cell_match_the_reference(n_ref, level, chunk_bytes):
    """A1, the Gram and the member tables of the chunked per-cell assembly
    against the reference's."""
    check_super_blocks(n_ref, level, chunk_bytes)
