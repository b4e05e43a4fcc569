"""cmfrec_torch's data-parallel ``mesh=`` on the bucketed drivers, the
collective fits and distributed topN, on 2-rank gloo groups on the CPU
(the port's counterpart of tests/test_multidevice.py:76-185).

One spawned group (tests/mesh_cases.py) runs every case of this file on
each of its ranks; the parametrised tests read its results, so each case
counts.  The tests that need no rank run first, while the ranks work.  Each case holds:
  (i)   every rank to rank 0's bits;
  (ii)  the mesh fit to the port's meshless fit, bitwise: a row share
        changes no row's arithmetic on these routes (each rank solves its
        rows against the same whole opposing matrix, and the all-gather
        copies), and a world of one, run in this process, to the
        meshless fit bitwise;
  (iii) the mesh fit to cmfrec_tpu's same call on the same numpy inputs and
        init= factors, meshless, at the matching test_multidevice.py
        tolerances (:82 the half-step, :98-119 the drivers, :148-169 the
        collective fits, :185 topN; the CD case at the drivers').
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from cmfrec_torch.parallel import mesh as pmesh
from cmfrec_torch.solvers import drivers

from .mesh_cases import (
    CASES,
    LAYOUT,
    Group,
    Meshless,
    assert_close_to,
    assert_layout_group,
    assert_meshless,
    assert_ranks_agree,
    assert_share_is_cut,
    layout_problem,
    problem,
)

NAMES = ["halfstep", "explicit_cholesky", "explicit_cg", "explicit_cd",
         "implicit", "collective_explicit", "collective_implicit", "topn"]
# (rtol, atol) of each case against cmfrec_tpu
JAX_TOL = {"halfstep": (1e-5, 1e-6), "explicit_cholesky": (1e-4, 1e-5),
           "explicit_cg": (1e-4, 1e-5), "explicit_cd": (1e-4, 1e-5),
           "implicit": (1e-4, 1e-5), "collective_explicit": (1e-4, 1e-5),
           "collective_implicit": (1e-4, 1e-5), "topn": (1e-6, 0.0)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(NAMES + LAYOUT, 2, tmp_path_factory.mktemp("mesh"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one in this process: the mesh path (slicing and
    collectives) at world size 1."""
    import torch.distributed as dist

    mesh = pmesh.init_distributed(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshless():
    return Meshless()


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one_is_meshless(world_of_one, meshless, name):
    assert_meshless(CASES[name]("port", world_of_one), meshless[name])


@pytest.mark.parametrize("name", NAMES)
def test_mesh_matches_cmfrec_tpu(group, name):
    # cmfrec_tpu first: the group's ranks run meanwhile
    want = CASES[name]("jax", None)
    assert_close_to(group.results()[name][0], want, {None: JAX_TOL[name]})


@pytest.mark.parametrize("name", NAMES)
def test_ranks_agree(group, name):
    assert_ranks_agree(group.results()[name])


@pytest.mark.parametrize("name", NAMES)
def test_mesh_matches_meshless(group, meshless, name):
    assert_meshless(group.results()[name][0], meshless[name])


def test_parallel_modules_import_no_jax():
    """cmfrec_torch/parallel/*.py import neither jax nor cmfrec_tpu."""
    root = Path(pmesh.__file__).parent
    files = sorted(root.glob("*.py"))
    assert {f.name for f in files} >= {"mesh.py", "topn.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib",
                                                 "cmfrec_tpu"), (f, mod)


@pytest.mark.parametrize("fit", ["explicit", "implicit", "lbfgs", "offsets"])
def test_a_mesh_that_is_not_a_device_mesh_raises(fit):
    from cmfrec_torch.solvers import lbfgs, offsets

    rows, cols, vals, m, n = problem()
    call = {"explicit": drivers.fit_explicit_als,
            "implicit": drivers.fit_implicit_als,
            "lbfgs": lbfgs.fit_collective_explicit_lbfgs,
            "offsets": offsets.fit_offsets_explicit_lbfgs}[fit]
    with pytest.raises(TypeError, match="DeviceMesh"):
        call(rows, cols, np.abs(vals) + 1, m, n, k=2, mesh=object(),
             device="cpu")


def test_mesh_device_and_size_checks(world_of_one):
    with pytest.raises(ValueError, match="'cpu' DeviceMesh.*'cuda'"):
        pmesh.check_mesh(world_of_one, "cuda")
    pmesh.check_mesh(world_of_one, "cpu")
    with pytest.raises(ValueError, match="n_devices=2"):
        pmesh.make_mesh(2, device_type="cpu")
    assert pmesh.world_rank(world_of_one) == (1, 0)
    assert pmesh.mesh_row_block(world_of_one) == 8


def test_the_ring_raises_naming_slice_7b(world_of_one):
    """Since slice 7b the ring fits (tests/test_torch_ring.py): its gates
    raise the JAX package's messages, and shard_opposing(shard_rows=True)
    returns this rank's share of the rows, zero rows appended to a
    multiple of the world size (the whole at a world of one)."""
    rows, cols, vals, m, n = problem()
    with pytest.raises(ValueError, match="use_cg=False"):
        drivers.fit_explicit_als(rows, cols, vals, m, n, k=2,
                                 mesh=world_of_one, shard_opposing_rows=True,
                                 device="cpu")
    with pytest.raises(ValueError, match="requires mesh="):
        drivers.fit_explicit_als(rows, cols, vals, m, n, k=2, use_cg=False,
                                 shard_opposing_rows=True, device="cpu")
    opp = torch.arange(10.0).reshape(5, 2)
    share = pmesh.shard_opposing(opp, world_of_one, shard_rows=True)
    assert share is not opp
    torch.testing.assert_close(share, opp, rtol=0, atol=0)
    assert pmesh.shard_opposing(opp, world_of_one) is opp
    assert pmesh.shard_opposing(opp, None, shard_rows=True) is opp


def test_checkpoint_under_a_mesh(world_of_one, tmp_path):
    """Rank 0 writes the mid-fit checkpoint (the others wait at a barrier):
    at a world of one the file is the meshless fit's, bit for bit."""
    from cmfrec_torch.utils.checkpoint import load_fit_checkpoint

    rows, cols, vals, m, n = problem()
    saved = []
    for name, mesh in (("meshless", None), ("mesh", world_of_one)):
        path = str(tmp_path / f"{name}.npz")
        drivers.fit_explicit_als(rows, cols, vals, m, n, k=3, niter=3,
                                 engine="sparse", checkpoint_path=path,
                                 checkpoint_every=1, mesh=mesh, device="cpu")
        saved.append(load_fit_checkpoint(path))
    (want, done_want), (got, done) = saved
    assert done == done_want == 2 and got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# each rank's share of the bucketed layouts (data/device_fill.py), on this
# file's 2-rank group (its LAYOUT cases run after NAMES) and its world of one


@pytest.mark.parametrize("name", LAYOUT)
def test_share_build_is_the_cut(group, name):
    """On this file's 2-rank group: every rank's share build of every
    bucketed layout (both sides of the main one, weighted and not, with
    side-info-only entities; the feature side; the aligned parts; the dense
    slices) equals the cut of the whole build bit for bit, and a rank
    uploads only its share's entries (tests/mesh_cases.py:
    assert_layout_group)."""
    assert_layout_group(group.results()[name], name)


@pytest.mark.parametrize("name", [n for n in LAYOUT if n != "layout_uploads"])
def test_share_build_world_of_one(world_of_one, name):
    """At a world of one (this process) the share builds are the cut of the
    whole build."""
    assert_share_is_cut(CASES[name]("port", world_of_one))


@pytest.mark.parametrize("weighted", [False, True])
def test_share_build_world_of_one_is_meshless(world_of_one, weighted):
    """At a world of one the share build is the meshless build, which it is
    both plan and share of: the same plan and the same tensors, bit for
    bit, and the whole entries uploaded once."""
    from cmfrec_torch.data import device_fill

    rows, cols, vals, wgt, m, n = layout_problem()
    w = wgt if weighted else None
    sizes = []
    real = device_fill._upload
    device_fill._upload = lambda a, dt, dev: (sizes.append(np.asarray(a).size)
                                              or real(a, dt, dev))
    try:
        plans, shares = device_fill.build_bucketed_pair_share(
            rows, cols, vals, m, n, w, device="cpu", mesh=world_of_one)
    finally:
        device_fill._upload = real
    assert sizes == [rows.size] * (4 if weighted else 3)
    want = device_fill.build_bucketed_pair(rows, cols, vals, m, n, w,
                                           device="cpu")
    for plan, share, lay in zip(plans, shares, want):
        assert plan is share
        for key in ("perm", "row_of", "counts"):
            np.testing.assert_array_equal(getattr(plan, key),
                                          getattr(lay, key))
        assert len(plan.buckets) == len(lay.buckets)
        for b, c in zip(plan.buckets, lay.buckets):
            assert (b.start, b.n_rows, b.n_real, b.width) == (
                c.start, c.n_rows, c.n_real, c.width)
            for f in ("idx", "val", "length", "wgt"):
                x, y = getattr(b, f), getattr(c, f)
                assert (x is None) == (y is None) and (
                    x is None or torch.equal(x, y)), f
