"""``nf4_tpu_torch.utils.kernel_variants`` edits the CUDA sources and their
headers as text: every variant's edits must still find their text in the
sources as they are, or the tool would stop at its first call on the card."""

import pytest

from nf4_tpu_torch.utils.kernel_variants import DECODE_VARIANTS, VARIANTS, edited_sources

CASES = [(source, name, edits) for source, variants in VARIANTS.items() for name, edits, _ in variants]
CASES += [("matmul", f"decode {name}", edits) for name, edits, _ in DECODE_VARIANTS]


@pytest.mark.parametrize("source,name,edits", CASES, ids=[f"{s}:{n}" for s, n, _ in CASES])
def test_variant_edits_apply(source, name, edits):
    texts = edited_sources(source, edits)
    assert f"{source}.cu" in texts
    for _, new in edits:
        assert any(new in text for text in texts.values())
    assert (texts == edited_sources(source, [])) == (not edits)
