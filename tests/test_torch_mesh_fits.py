"""cmfrec_torch's data-parallel ``mesh=`` on the dense-masked engine, the
L-BFGS and offsets fits (2-rank gloo group), and on a world of 3, on the
CPU (the port's counterpart of tests/test_multidevice.py:189-239, :265-279
and :550-612).  tests/test_torch_mesh.py says how the cases run and what
(i)-(iii) hold; here:
  (ii)  the ALS cases bitwise; the L-BFGS cases within 1e-10 of max|x|:
        their objective and gradient are the ranks' partial sums added
        (float64, 25 iterations);
  (iii) at test_multidevice.py's tolerances: :206 the dense fit's
        predictions, :240 exact mode, :281 a world of 3, :574 and :596
        L-BFGS, :610 offsets ALS.
"""

import pytest

from .mesh_cases import (
    CASES,
    LAYOUT,
    Group,
    Meshless,
    assert_close_to,
    assert_layout_group,
    assert_meshless,
    assert_ranks_agree,
    problem,
)

NAMES = ["dense_plain", "dense_exact", "dense_rows", "lbfgs",
         "offsets_lbfgs", "offsets_als"]
# cases with an L-BFGS fit: its objective and gradient sum the ranks' parts
LBFGS = ("lbfgs", "offsets_lbfgs")
# (rtol, atol) against cmfrec_tpu, by case and key (None: every key)
JAX_TOL = {
    "dense_plain": {"pred": (1e-3, 1e-3)},
    "dense_exact": {None: (0.0, 5e-4), "pred": None},
    "dense_rows": {"pred": (1e-3, 1e-3)},
    "lbfgs": {None: (1e-6, 1e-8)},
    "offsets_lbfgs": {None: (1e-6, 1e-8)},
    "offsets_als": {None: (1e-4, 1e-5)},
    "explicit_world3": {"A": (5e-3, 1e-4)},
}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(NAMES, 2, tmp_path_factory.mktemp("mesh2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def group3(tmp_path_factory):
    g = Group(["explicit_world3"] + LAYOUT, 3,
              tmp_path_factory.mktemp("mesh3"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def meshless():
    return Meshless()


def _results(group, group3, name):
    return (group3 if name == "explicit_world3" else group).results()[name]


ALL = NAMES + ["explicit_world3"]


@pytest.mark.parametrize("name", ALL)
def test_ranks_agree(group, group3, name):
    assert_ranks_agree(_results(group, group3, name))


@pytest.mark.parametrize("name", ALL)
def test_mesh_matches_meshless(group, group3, meshless, name):
    assert_meshless(_results(group, group3, name)[0], meshless[name],
                    summed=name in LBFGS)


@pytest.mark.parametrize("name", ALL)
def test_mesh_matches_cmfrec_tpu(group, group3, name):
    assert_close_to(_results(group, group3, name)[0],
                    CASES[name]("jax", None), JAX_TOL[name])


def test_world3_row_block(group3):
    """Bucket rows pad to lcm(8, 3) = 24 (tests/test_multidevice.py:271),
    and the seeded start of that layout is the meshless one, row for row
    (init_blocks draws over the ROW_BLOCK layout)."""
    import torch

    from cmfrec_torch.data.device_fill import build_bucketed_pair
    from cmfrec_torch.parallel.mesh import mesh_row_block
    from cmfrec_torch.solvers.als import blocks_to_orig, init_blocks

    rows, cols, vals, m, n = problem()
    assert mesh_row_block(None) == 8

    lay8, _ = build_bucketed_pair(rows, cols, vals, m, n, device="cpu")
    lay24, _ = build_bucketed_pair(rows, cols, vals, m, n, device="cpu",
                                   row_block=24)
    assert all(b.n_rows % 24 == 0 for b in lay24.buckets)
    starts = []
    for lay in (lay8, lay24):
        gen = torch.Generator()
        gen.manual_seed(5)
        starts.append(blocks_to_orig(init_blocks(gen, lay, 5, 8),
                                     torch.as_tensor(lay.perm)))
    torch.testing.assert_close(starts[0], starts[1], rtol=0, atol=0)
    assert group3.world == 3


@pytest.mark.parametrize("name", LAYOUT)
def test_share_build_is_the_cut_world3(group3, name):
    """On this file's 3-rank group (its LAYOUT cases run after
    explicit_world3): every rank's share build of every bucketed layout
    equals the cut of the whole build bit for bit, and a rank uploads only
    its share's entries (tests/mesh_cases.py:assert_layout_group)."""
    assert_layout_group(group3.results()[name], name)
