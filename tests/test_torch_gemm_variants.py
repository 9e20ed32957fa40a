"""The 3xTF32 GEMM's ablation tool (tools/gemm_tf32x3_variants.py) patches
``csrc/gemm_tf32x3.cu`` and its lockstep yardstick
``csrc/gemm_tf32x3_lockstep.cu`` textually. Every anchor must occur
exactly once in its source, so that a refactor of either kernel fails
here, on the CPU, instead of after a build on the card. The tool imports
torch only inside its functions: nothing is built."""
import pytest

from tools import gemm_tf32x3_variants as variants

CASES = [(design, name) for design, (_, table, _, _) in
         sorted(variants.DESIGNS.items()) for name in sorted(table)]


@pytest.mark.parametrize('design,name', CASES)
def test_every_anchor_occurs_once(design, name):
    source = variants.DESIGNS[design][0].read_text()
    for anchor, replacement in variants.patches_of(name, design):
        assert source.count(anchor) == 1, (design, name, anchor)
        assert anchor != replacement
    patched = variants.patched_source(name, design)
    assert (patched == source) == (not variants.patches_of(name, design))


def test_both_designs_have_the_same_variants():
    tables = [table for _, table, _, _ in variants.DESIGNS.values()]
    assert all(set(t) == set(tables[0]) for t in tables)


def test_the_cases_are_vit_b16s_step():
    assert len(variants.CASES) == 6 and len(set(variants.CASES)) == 6
    assert [n for _, _, n in variants.LINEARS] == [2304, 768, 3072, 768]
