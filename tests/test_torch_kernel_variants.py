"""``nf4_tpu_torch.utils.kernel_variants`` edits the CUDA sources as text:
every variant's edits must still find their text in the sources as they
are, or the tool would stop at its first call on the card."""

import pytest

from nf4_tpu_torch.utils.kernel_variants import VARIANTS, edited_source

CASES = [(source, name, edits) for source, variants in VARIANTS.items() for name, edits, _ in variants]


@pytest.mark.parametrize("source,name,edits", CASES, ids=[f"{s}:{n}" for s, n, _ in CASES])
def test_variant_edits_apply(source, name, edits):
    text = edited_source(source, edits)
    for _, new in edits:
        assert new in text
    assert (text == edited_source(source, [])) == (not edits)
