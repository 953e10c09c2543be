"""Each cell's control comes out not correct through the harness's own run
and comparison: the plain reference put in the program's place and
computed one precision below what the configuration states (TF32 matrix
operands where the cell resamples, bfloat16 elsewhere), at a size the CPU
holds. The same runs at the cells' own sizes are control.py's, on the
card."""

from __future__ import annotations

import pytest

from benchmark_torch import control, harness, reference, spec

from .conftest import TINY, run_tiny


@pytest.mark.parametrize("name", TINY)
def test_control_is_not_correct(tiny, name):
    root, here = tiny
    prec = control.precision_of(spec.load_cell(name, root, here))
    out = run_tiny(tiny, name, hook=control.plant(prec))
    assert out["attempted"] > 0 and out["failed"] == 0
    assert not out["correct"], out["compared"]


def test_the_reference_in_the_controls_place_is_correct(tiny):
    """The planted path itself is sound: at the stated precision the same
    run is correct, so the controls fail by their precision alone."""
    out = run_tiny(tiny, "t.resize", hook=control.plant("float32"))
    assert out["correct"], out["compared"]


def test_each_control_is_one_precision_below_float32(tiny):
    root, here = tiny
    precs = {control.precision_of(spec.load_cell(n, root, here))
             for n in TINY}
    assert precs <= set(reference.PRECISIONS) - {"float32"}
    assert harness.resize_of(spec.load_cell("t.resize", root, here))
