"""cmfrec_torch's big-axis ring (``shard_opposing_rows=True``,
cmfrec_torch/parallel/ring.py) on gloo groups on the CPU: the port's
counterpart of the 13 ring cases of tests/test_multidevice.py:282-548.

One spawned 2-rank group and one 3-rank group (tests/mesh_cases.py's
``Group`` playing tests/ring_cases.py) run the cases on every rank; the
parametrised tests read their results, so each case counts.  cmfrec_tpu's
results are computed meanwhile by three spawned processes (``Refs``): most
of the file's time is JAX compiling.  Each case holds:
  (i)   every rank to rank 0's bits;
  (ii)  the ring fit to the port's meshless fit of the same call and init=,
        at the JAX tests' tolerances (explicit 1e-4 / 1e-5, implicit
        2e-3 / 1e-4, float64 1e-9 / 1e-10): over two or three ranks a
        row's Gram and rhs add the shards' sums one after the other, and a
        Gram base adds the ranks' partial sums, not one sum.  A world of
        one, run in this process, is bitwise the meshless fit on every
        case: one shard holds every slot, and the ring sums a base over
        the rows in their original order (parallel/ring.py:row_sum);
  (iii) the fit to cmfrec_tpu's meshless fit from the same init= at the
        same tolerances, the ring's system to cmfrec_tpu's
        ring_part_system on a 2-device mesh, and the explicit Cholesky fit
        also to cmfrec_tpu's own ring fit (make_mesh(2),
        shard_opposing_rows=True).
"""

import numpy as np
import pytest

from .mesh_cases import Group, Refs, assert_ranks_agree
from .ring_cases import CASES, _collective, _drivers, ring_problem

NAMES = list(CASES)
EXPLICIT = (1e-4, 1e-5)
IMPLICIT = (2e-3, 1e-4)
# (rtol, atol) of each case, ring against meshless and against cmfrec_tpu
TOL = {"ring_halfstep": (1e-5, 1e-6), "ring_system": (1e-5, 1e-5),
       "explicit": EXPLICIT, "explicit_na0": EXPLICIT,
       "explicit_nonneg": EXPLICIT, "explicit_f64": (1e-9, 1e-10),
       "implicit": IMPLICIT, "never_materializes": EXPLICIT,
       "checkpoint": EXPLICIT,
       "collective_explicit": EXPLICIT, "collective_dense_ifeat": EXPLICIT,
       "collective_implicit": IMPLICIT}
# the keys the collectives' record adds to never_materializes
RECORD = ("gather_rows", "send_shapes")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(NAMES, 2, tmp_path_factory.mktemp("ring2"), "tests.ring_cases")
    yield g
    g.close()


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """cmfrec_tpu's results by name: three batches in spawned processes
    that compute them while the port-only tests run (each batch about a
    third of the JAX time), anything else here when first asked for."""
    g = Refs([["collective_explicit", "implicit", "explicit_nonneg",
               "checkpoint"],
              ["collective_dense_ifeat", "collective_implicit",
               "explicit_na0", "ring_system"],
              ["explicit", "explicit:jax_ring", "explicit_f64",
               "ring_halfstep", "never_materializes"]],
             tmp_path_factory.mktemp("refs"), "tests.ring_cases")
    here = {}

    def get(name):
        if name in g.names:
            return g.results()[name]
        if name not in here:
            case, _, pkg = name.partition(":")
            here[name] = CASES[case](pkg or "jax", None)
        return here[name]

    yield get
    g.close()


@pytest.fixture(scope="module")
def group3(tmp_path_factory):
    g = Group(["explicit"], 3, tmp_path_factory.mktemp("ring3"),
              "tests.ring_cases")
    yield g
    g.close()


@pytest.fixture(scope="module", autouse=True)
def _started(group, group3, refs):
    """The ranks and the reference processes start with the first test."""


@pytest.fixture(scope="module")
def meshless():
    out = {}

    def get(name):
        if name not in out:
            out[name] = CASES[name]("port", None)
        return out[name]

    return get


@pytest.fixture(scope="module")
def world_of_one():
    import torch.distributed as dist

    from cmfrec_torch.parallel.mesh import init_distributed

    mesh = init_distributed(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _close(got, want, tol, bitwise=False):
    """Each array of ``want`` (the record's keys aside) against ``got``."""
    for key in want:
        if key in RECORD:
            continue
        if bitwise:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=tol[0],
                                       atol=tol[1], err_msg=key)


def _ranks(group, group3, name):
    return (group3.results()["explicit"] if name == "explicit_world3"
            else group.results()[name])


ALL = NAMES + ["explicit_world3"]


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one(world_of_one, meshless, name):
    _close(CASES[name]("port", world_of_one), meshless(name), TOL[name],
           bitwise=True)


# cmfrec_tpu/solvers/drivers.py:200-208, :682-690
GATES = {"use_cg": "use_cg=False", "mesh": "requires mesh="}


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("fit", ["explicit", "implicit",
                                 "collective_explicit",
                                 "collective_implicit"])
def test_ring_gates(world_of_one, fit, gate):
    """shard_opposing_rows without a mesh, or with use_cg=True, raises the
    JAX package's message in both packages (:474-548's gate tests)."""
    from cmfrec_tpu.parallel.mesh import make_mesh

    rows, cols, vals, m, n = ring_problem()
    vals = np.abs(vals) + 1.0
    for pkg, mesh in (("port", world_of_one), ("jax", make_mesh(2))):
        mod = (_collective if fit.startswith("collective") else _drivers)(pkg)
        call = getattr(mod, f"fit_{fit}_als")
        kw = dict(k=2, shard_opposing_rows=True)
        if gate == "use_cg":
            kw.update(mesh=mesh, use_cg=True)
        else:
            kw.update(use_cg=False)
        if pkg == "port":
            kw["device"] = "cpu"
        with pytest.raises(ValueError, match=GATES[gate]):
            call(rows, cols, vals, m, n, **kw)


class _Mesh:
    """What parallel/mesh.py:world_rank reads of a DeviceMesh."""

    def __init__(self, world, rank):
        self.world, self.rank = world, rank

    def size(self):
        return self.world

    def get_local_rank(self):
        return self.rank


@pytest.mark.parametrize("lengths", [True, False])
@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (3, 2), (4, 1)])
def test_shard_slots_hold_each_slot_once(world, rank, lengths):
    """Over a ring's D stops ShardSlots hands out every slot below its
    row's length (every slot without lengths) once, at the stop whose
    visiting shard ((rank + t) mod D) holds its row, with its row there."""
    import torch

    from cmfrec_torch.parallel.ring import ShardSlots

    rng = np.random.default_rng(world * 10 + rank)
    chunk, R, L = 7, 64, 9
    idx = rng.integers(0, chunk * world, (R, L))
    length = rng.integers(0, L + 1, R) if lengths else np.full(R, L)
    slots = ShardSlots(torch.as_tensor(idx, dtype=torch.int32),
                       torch.as_tensor(length, dtype=torch.int32)
                       if lengths else None, chunk, _Mesh(world, rank))
    seen = np.zeros(R * L, np.int64)
    for t in range(world):
        pos, loc = (a.numpy() for a in slots.stop(t))
        shard = (rank + t) % world
        seen[pos] += 1
        np.testing.assert_array_equal(idx.reshape(-1)[pos],
                                      loc + shard * chunk)
    live = np.arange(L)[None, :] < length[:, None]
    np.testing.assert_array_equal(seen, live.reshape(-1).astype(np.int64))


@pytest.mark.parametrize("name", ALL)
def test_ranks_agree(group, group3, name):
    assert_ranks_agree(_ranks(group, group3, name))


@pytest.mark.parametrize("name", ALL)
def test_ring_matches_meshless(group, group3, meshless, name):
    case = name.replace("_world3", "")
    _close(_ranks(group, group3, name)[0], meshless(case), TOL[case])


def test_never_materializes_opposing(group):
    """During the iterations no rank all-gathers an opposing matrix of
    RING_MIN_ROWS x D rows or more (here none is gathered at all), and the
    ring sends D-1 shards of S/D rows a ringed part and bucket: each A and
    B shard [S/D, K] and its biases [S/D], as each half-step's opposing
    matrix (tests/test_multidevice.py:450-471)."""
    from cmfrec_torch.data.device_fill import build_bucketed_pair
    from cmfrec_torch.parallel.ring import RING_MIN_ROWS

    rows, cols, vals, m, n = ring_problem()
    world, niter, K = 2, 4, 8
    RB, CB = build_bucketed_pair(rows, cols, vals, m, n, device="cpu")
    chunk_A, chunk_B = RB.n_rows_pad // world, CB.n_rows_pad // world
    assert min(RB.n_rows_pad, CB.n_rows_pad) >= RING_MIN_ROWS * world
    # B's half-step rings A once a bucket of B, and A's rings B
    sends = (world - 1) * niter
    want = sorted([(chunk_A, K), (chunk_A, 0)] * sends * len(CB.buckets)
                  + [(chunk_B, K), (chunk_B, 0)] * sends * len(RB.buckets))
    for rec in group.results()["never_materializes"]:
        assert not np.any(rec["gather_rows"] >= RING_MIN_ROWS * world)
        assert sorted(map(tuple, rec["send_shapes"].tolist())) == want


@pytest.mark.parametrize("name", ALL)
def test_ring_matches_cmfrec_tpu(group, group3, refs, name):
    # last in the file: the port-only tests run while cmfrec_tpu compiles
    case = name.replace("_world3", "")
    _close(_ranks(group, group3, name)[0], refs(case), TOL[case])


def test_explicit_matches_cmfrec_tpu_ring(group, refs):
    """The explicit Cholesky fit against cmfrec_tpu's own ring on two
    devices (tests/test_multidevice.py:346-366)."""
    _close(group.results()["explicit"][0], refs("explicit:jax_ring"),
           EXPLICIT)
