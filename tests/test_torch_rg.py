"""The port's regions (slepc_tpu_torch/rg/rg.py) against slepc_tpu's, on the
CPU.

Both are host numpy, so the same seeded points give exactly the same
inside / outside answers, contours and bounding boxes: for each of the four
region kinds, plain, complemented and scaled (the interop copy carries the
complement flag and the scale factor over).
"""

import numpy as np
import pytest

import slepc_tpu as jst
import slepc_tpu_torch as tst
from slepc_tpu_torch import interop

_REGIONS = {
    "ellipse": lambda p: p.RGEllipse(center=0.3 - 0.2j, radius=1.1,
                                     vscale=0.6),
    "interval": lambda p: p.RGInterval(-0.7, 1.2, -0.4, 0.9),
    "segment": lambda p: p.RGInterval(-0.5, 0.8),
    "polygon": lambda p: p.RGPolygon([-1 - 1j, 1.2 - 0.8j, 0.9 + 1.1j,
                                      -0.2 + 0.4j, -1.1 + 0.7j]),
    "ring": lambda p: p.RGRing(center=0.1j, radius=0.9, vscale=1.3,
                               start_ang=0.1, end_ang=0.7, width=0.4),
    "ring_wrap": lambda p: p.RGRing(radius=1.0, start_ang=0.8, end_ang=0.2,
                                    width=0.3),
}


def _points(seed=0, k=400):
    rng = np.random.default_rng(seed)
    z = 1.6 * (rng.standard_normal(k) + 1j * rng.standard_normal(k))
    # the real axis (the segment's only inside points) and a few exact ones
    return np.concatenate([z, rng.uniform(-1.5, 1.5, 40) + 0j,
                           [0.0, 1.2, -0.7, 0.9j]])


@pytest.mark.parametrize("variant", ["plain", "complement", "scaled"])
@pytest.mark.parametrize("kind", sorted(_REGIONS))
def test_region_matches_the_reference(kind, variant):
    jrg = _REGIONS[kind](jst)
    trg = _REGIONS[kind](tst)
    if variant == "complement":
        jrg.set_complement()
        trg.set_complement()
    if variant == "scaled":
        jrg.set_scale(2.5)
        trg.set_scale(2.5)
    z = _points()
    inside = trg.check_inside(z)
    np.testing.assert_array_equal(inside, jrg.check_inside(z))
    assert set(np.unique(inside)) <= {-1, 0, 1} and (inside == 1).any()
    assert trg.check_inside(z[3]) == jrg.check_inside(z[3])  # a scalar
    zt, wt = trg.contour(64)
    zj, wj = jrg.contour(64)
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(trg.bounding_box(), jrg.bounding_box())
    assert trg.is_trivial() == jrg.is_trivial()
    # interop: the same region from the reference's object
    crg = interop.rg_from_slepc_tpu(jrg)
    assert type(crg) is type(trg)
    np.testing.assert_array_equal(crg.check_inside(z), inside)


def test_trivial_regions_and_a_bad_polygon():
    for args in ((), (0.0, 1.0), (-np.inf, np.inf, -1.0, 1.0),
                 (-np.inf, np.inf, -np.inf, np.inf)):
        assert tst.RGInterval(*args).is_trivial() == \
            jst.RGInterval(*args).is_trivial()
    assert tst.RGInterval(-np.inf, np.inf, -np.inf, np.inf).is_trivial()
    with pytest.raises(ValueError, match="3 vertices"):
        tst.RGPolygon([0, 1])
