"""cmfrec_torch's data-parallel ``mesh=`` through the five models' ``fit``
(CMF, CMF_implicit, OMF_explicit, OMF_implicit, ContentBased) on a 2-rank
gloo group on the CPU (the port's counterpart of
tests/test_multidevice.py:244-262).  tests/test_torch_mesh.py says how the
cases run and what (i)-(iii) hold; here:
  (ii)  CMF and CMF_implicit bitwise; the offsets models, whose L-BFGS fits
        sum the ranks' parts of the objective, within 1e-10 of max|x|;
  (iii) at test_multidevice.py's tolerances: :260-262 for CMF and
        CMF_implicit, :596 for the offsets models' L-BFGS, :610 for
        OMF_implicit's ALS.
"""

import pytest

from .mesh_cases import (
    CASES,
    Group,
    Meshless,
    assert_close_to,
    assert_meshless,
    assert_ranks_agree,
)

NAMES = ["models", "omf_models"]
# (rtol, atol) against cmfrec_tpu, by case and key (None: every key)
JAX_TOL = {
    "models": {"cmf_A": (1e-3, 1e-4), "implicit_A": (8e-3, 1e-4)},
    "omf_models": {None: (1e-6, 1e-8), "omf_implicit_Am_": (1e-4, 1e-5),
                   "omf_implicit_C_": (1e-4, 1e-5)},
}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(NAMES, 2, tmp_path_factory.mktemp("mesh_models"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def meshless():
    return Meshless()


@pytest.mark.parametrize("name", NAMES)
def test_mesh_matches_cmfrec_tpu(group, name):
    # cmfrec_tpu first: the group's ranks run meanwhile
    want = CASES[name]("jax", None)
    assert_close_to(group.results()[name][0], want, JAX_TOL[name])


@pytest.mark.parametrize("name", NAMES)
def test_ranks_agree(group, name):
    assert_ranks_agree(group.results()[name])


@pytest.mark.parametrize("name", NAMES)
def test_mesh_matches_meshless(group, meshless, name):
    assert_meshless(group.results()[name][0], meshless[name],
                    summed=name == "omf_models")
