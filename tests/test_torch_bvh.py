"""The BVH route's trees and traversals in the PyTorch port, against
``elaina_tpu``.

The trees: the port's ``make_geom_set(..., bvh=True)`` builds the JAX
package's fields bit for bit (the native builder for the prim tree, the
numpy one for the silhouette entities' tree, the subtree measures and the
normal cones), and ``geom_set_from_arrays`` carries the JAX GeomSet's
arrays into the port.  The traversals: each plain version (the one a CPU
tensor takes; ``chip_smoke.py`` holds the CUDA kernels B1-B4 to them on
the card) on one tree and one set of inputs made with numpy from a seed,
against the JAX function.  Distances and t agree to 1e-5; ids exactly,
but where two prims tie within that (a shared vertex or edge: the
frameworks round the last bit of a distance apart and take the other);
the in-ball sample's ids on >= 99.5% of the lanes (a CDF entry a rounding
apart can flip) and its pdf within XLA-CPU's transcendental floor plus
the conditioning of the Green's function at the sampled prim
(``tests/test_torch_queries.py``'s rule, in 3D with G's own).
"""

import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry import queries as QJ  # noqa: E402
from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu_torch.geometry import geomset as TGS  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.ops import bvh as B  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5
TOOLS = os.path.join(os.path.dirname(__file__), os.pardir, "tools")
TREE_FIELDS = ("bb_min", "bb_max", "left", "right", "leaf_prims",
               "node_measure", "sil_bb_min", "sil_bb_max", "sil_left",
               "sil_right", "sil_leaf", "sil_cone_axis", "sil_cone_cos")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU ops gain nothing
    from more, and in a parallel test run the OpenMP pool's waits stall
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavy_circle(n, r0=3.0, amp=0.6, waves=12):
    """tests/test_queries_hier.py's closed wavy curve."""
    t = np.linspace(0, 2 * math.pi, n, endpoint=False)
    r = r0 + amp * np.sin(waves * t)
    verts = np.stack([r * np.cos(t), r * np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    return verts, idx


def _open_arcs(n_arcs, per_arc):
    """tests/test_queries_hier.py's disjoint open arcs: every arc end is
    an always-silhouette entity."""
    rng = np.random.default_rng(5)
    verts, idx = [], []
    base = 0
    for _ in range(n_arcs):
        c = rng.uniform(-4, 4, 2)
        r = rng.uniform(0.2, 0.6)
        t = rng.uniform(0, 2 * math.pi) + np.linspace(0, 1.5, per_arc + 1)
        verts.append(c + r * np.stack([np.cos(t), np.sin(t)], -1))
        idx.append(np.stack([np.arange(per_arc), np.arange(per_arc) + 1],
                            -1) + base)
        base += per_arc + 1
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(idx).astype(np.int32))


def _mesh():
    """tools/make_scene3d.py's bumpy sphere at subdivision 4: 5,120
    triangles, 7,680 edges."""
    sys.path.insert(0, TOOLS)
    try:
        from make_scene3d import make_mesh
    finally:
        sys.path.remove(TOOLS)
    verts, idx = make_mesh(4)
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


MESHES = {"2d": lambda: _wavy_circle(4200), "3d": _mesh,
          "arcs": lambda: _open_arcs(600, 8)}
_BUILT: dict = {}


def _sets(name):
    """(name, JAX GeomSet, its depth, the port's GeomSet carried from the
    JAX arrays, the port's own build), built once a module."""
    if name not in _BUILT:
        verts, idx = MESHES[name]()
        gj, depth = make_geom_set(verts, idx)
        gp = TGS.geom_set_from_arrays(_jax_arrays(gj), CPU)
        own = TGS.make_geom_set(verts, idx, CPU, bvh=True)
        _BUILT[name] = (name, gj, depth, gp, own)
    return _BUILT[name]


@pytest.fixture(scope="module", params=["2d", "3d"])
def sets(request):
    """The 2D curve of 4,200 segments and the 3D mesh."""
    return _sets(request.param)


@pytest.fixture(scope="module", params=["arcs", "3d"])
def sil_sets(request):
    """Disjoint open arcs (tests/test_queries_hier.py:27) and the 3D
    mesh, for the silhouette descent."""
    return _sets(request.param)


def _jax_arrays(gj) -> dict:
    return {k: None if v is None else np.asarray(v)
            for k, v in gj._asdict().items()}


def _queries(name, n, seed):
    rng = np.random.default_rng(seed)
    if name == "3d":
        return rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    return rng.uniform(-4.5, 4.5, (n, 2)).astype(np.float32)


def test_tree_matches_jax(sets):
    """Every tree field bit for bit, and the depths."""
    name, gj, depth, _, own = sets
    assert gj.sil_bb_min is not None and gj.node_measure is not None
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert own.depth == depth
    assert own.sil_depth == TGS.tree_depth(np.asarray(gj.sil_left),
                                           np.asarray(gj.sil_right))
    assert own.stack_size == depth + 4


def test_geom_set_from_arrays_equals_build(sets):
    """The JAX GeomSet's arrays carried over give the port's own build:
    every tensor equal, the depths read off the trees equal."""
    _, _, _, gp, own = sets
    for f, v in vars(own).items():
        w = getattr(gp, f)
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype, f
            np.testing.assert_array_equal(w.numpy(), v.numpy(), err_msg=f)
        else:
            assert v == w, f


def _tied(gp, q, ia, ib):
    """Where ids differ, the distances from q to both prims tie within
    TOL."""
    c = gp.corners
    D = gp.dim

    def dist(i):
        cc = c[torch.as_tensor(i).long()]
        return B._prim_dist(D, torch.as_tensor(q),
                            tuple(cc[:, k * D:(k + 1) * D]
                                  for k in range(D))).numpy()

    return np.abs(dist(ia) - dist(ib)) <= TOL * (1 + np.abs(dist(ia)))


def test_closest_point_matches_jax(sets):
    """B1's plain version through ``closest_point``'s dispatch, against
    the JAX traversal, on random points and on the set's own vertices (a
    tie at 0 between the prims that share one)."""
    name, gj, _, gp, _ = sets
    q = np.concatenate([_queries(name, 1000, 1),
                        np.asarray(gj.verts)[:200]])
    dj, ij = (np.asarray(a) for a in jax.jit(QJ.closest_point)(
        gj, jnp.asarray(q)))
    dp, ip = (a.numpy() for a in QT.closest_point(gp, torch.as_tensor(q)))
    np.testing.assert_allclose(dp, dj, rtol=TOL, atol=TOL)
    diff = ip != ij
    assert diff.mean() < 0.05
    assert _tied(gp, q[diff], ip[diff], ij[diff]).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_ray_matches_jax(sets, any_hit):
    """B2's plain version against the JAX traversal: the hit flags
    exactly; the closest hit's t and prim (the any-hit form's: the first
    hit found, in the same order); rays whose hits lie past tmax miss."""
    name, gj, _, gp, _ = sets
    rng = np.random.default_rng(2)
    n = 1000
    o = _queries(name, n, 3)
    d = rng.normal(size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.01, 4.0, n).astype(np.float32)
    hj, tj, ij = (np.asarray(a) for a in QJ.ray_intersect(
        gj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        any_hit=any_hit))
    hp, tp, ip = (a.numpy() for a in QT.ray_intersect(
        gp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax),
        any_hit=any_hit))
    assert 0.05 < hj.mean() < 0.95
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_allclose(tp[hj], tj[hj], rtol=TOL, atol=TOL)
    assert np.isinf(tp[~hj]).all() and (ip[~hj] == 0).all()
    np.testing.assert_array_equal(ip[hj], ij[hj])
    # a ray whose every hit lies past tmax misses
    far = hj & (tj > 1e-3)
    short = np.where(far, tj * 0.5, tmax).astype(np.float32)
    hs, ts, _ = (a.numpy() for a in QT.ray_intersect(
        gp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(short),
        any_hit=any_hit))
    hjs = np.asarray(QJ.ray_intersect(gj, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(short), any_hit=any_hit)[0])
    np.testing.assert_array_equal(hs, hjs)
    assert (ts[hs] <= short[hs]).all()
    if not any_hit:
        assert not hs[far].any()


def _green_kappa(dim, d, R):
    """The relative conditioning of G(d; R) in d: 1 / log(R / d) in 2D,
    R / (R - d) in 3D (float64, d clamped as the sampler clamps it)."""
    d = np.maximum(d, 1e-4)
    if dim == 2:
        return 1.0 / np.log(R / d)
    return R / np.maximum(R - d, 1e-30)


def _pdf_tol(gp, q, R, pid, pdf):
    """tests/test_torch_queries.py's ``_pdf_tolerance`` rule: 1e-4
    relative plus 4 float32 ulps times G's conditioning at the sampled
    prim."""
    c = gp.corners[torch.as_tensor(np.maximum(pid, 0)).long()].double()
    D = gp.dim
    d = B._prim_dist(D, torch.as_tensor(q).double(),
                     tuple(c[:, k * D:(k + 1) * D] for k in range(D))).numpy()
    kappa = np.where(pid >= 0, _green_kappa(D, d, R.astype(np.float64)), 0.0)
    ulp = float(np.finfo(np.float32).eps)
    return (1e-4 + 4 * ulp * kappa) * np.abs(pdf) + 1e-7


def test_sample_in_ball_matches_jax(sets):
    """B3's plain version against the JAX descent on the same uniforms:
    ids on >= 99.5% of the lanes, the pdf within the rule where the ids
    agree, and -1 / 0 exactly on the balls that hold no prim."""
    name, gj, _, gp, _ = sets
    rng = np.random.default_rng(4)
    n = 2000
    q = _queries(name, n, 5)
    R = rng.uniform(0.01, 1.5, n).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    pj, fj = (np.asarray(a) for a in QJ.sample_in_ball(
        gj, jnp.asarray(q), jnp.asarray(R), jnp.asarray(u)))
    pp, fp = (a.numpy() for a in QT.sample_in_ball(
        gp, torch.as_tensor(q), torch.as_tensor(R), torch.as_tensor(u)))
    assert (pj >= 0).mean() > 0.2 and (pj < 0).mean() > 0.05
    same = pp == pj
    assert same.mean() >= 0.995, same.mean()
    tol = _pdf_tol(gp, q, R, pj, fj)
    assert (np.abs(fp - fj) < tol)[same].all()
    empty = pj < 0
    assert (pp[empty] == -1).all() and (fp[empty] == 0).all()


def test_closest_silhouette_matches_jax(sil_sets):
    """B4's plain version against the JAX coned descent and the port's
    dense sweep."""
    name, gj, _, gp, _ = sil_sets
    q = _queries(name, 1000, 6)
    dj = np.asarray(jax.jit(QJ.closest_silhouette)(gj, jnp.asarray(q)))
    dp = QT.closest_silhouette(gp, torch.as_tensor(q)).numpy()
    sweep = TGS.geom_set_from_arrays(
        {k: v for k, v in _jax_arrays(gj).items()
         if not k.startswith(("sil_bb", "sil_left", "sil_right", "sil_leaf",
                              "sil_cone"))}, CPU)
    ds = QT.closest_silhouette(sweep, torch.as_tensor(q)).numpy()
    fin = np.isfinite(dj)
    assert fin.mean() > 0.5
    for other in (dp, ds):
        np.testing.assert_array_equal(np.isfinite(other), fin)
        np.testing.assert_allclose(other[fin], dj[fin], rtol=TOL, atol=TOL)


def test_live_masks(sets):
    """Lanes that ``live`` leaves out get the empty descent's outputs; the
    others, the unmasked outputs."""
    name, _, _, gp, _ = sets
    rng = np.random.default_rng(7)
    n = 600
    q = torch.as_tensor(_queries(name, n, 8))
    d = torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=tuple(q.shape)).astype(np.float32)), dim=1)
    R = torch.as_tensor(rng.uniform(0.05, 1.0, n).astype(np.float32))
    u = torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32))
    live = torch.as_tensor(rng.uniform(0, 1, n) < 0.6)
    off = ~live
    for fn, args, empty in (
            (B.closest_point_bvh, (q,), (float("inf"), 0)),
            (B.ray_bvh, (q, d, R), (False, float("inf"), 0)),
            (B.sample_in_ball_bvh, (q, R, u), (-1, 0.0)),
            (B.closest_silhouette_bvh, (q,), (float("inf"),))):
        full = fn(gp, *args)
        masked = fn(gp, *args, live=live)
        full = full if isinstance(full, tuple) else (full,)
        masked = masked if isinstance(masked, tuple) else (masked,)
        for a, b, e in zip(full, masked, empty):
            assert torch.equal(a[live], b[live]), fn.__name__
            assert (b[off] == e).all(), fn.__name__


def test_bvh_sampler_unbiased():
    """B3's plain version is a valid importance sampler
    (tests/test_queries_hier.py:98): w_true(idx) / pdf averages to the
    dense total of the Green-weighted measure in each ball, and -1 / 0
    where the ball is empty."""
    from elaina_tpu_torch.solver.green import GREEN_R_CLAMP, green_eval

    verts, idx = _wavy_circle(12000)
    gp = TGS.make_geom_set(verts, idx, CPU, bvh=True)
    assert gp.node_measure is not None
    rng = np.random.default_rng(3)
    n = 16
    q = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    R = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    a, b = verts[idx[:, 0]][None], verts[idx[:, 1]][None]
    e = b - a
    w = q[:, None, :] - a
    t = np.clip((w * e).sum(-1) / (e * e).sum(-1), 0, 1)
    d = np.linalg.norm(w - t[..., None] * e, axis=-1)
    meas = gp.prim_measure.numpy()[None]
    gw = green_eval(torch.as_tensor(np.maximum(d, GREEN_R_CLAMP)),
                    torch.as_tensor(R)[:, None], 2).numpy()
    w_true = np.where(d < R[:, None], meas * np.maximum(gw, 0), 0)
    totals = w_true.sum(-1)
    m = 3000
    u = rng.uniform(0, 1, (m * n,)).astype(np.float32)
    pid, pdf = QT.sample_in_ball(gp, torch.as_tensor(np.tile(q, (m, 1))),
                                 torch.as_tensor(np.tile(R, m)),
                                 torch.as_tensor(u))
    pid = pid.numpy().reshape(m, n)
    pdf = pdf.numpy().reshape(m, n)
    chosen = pid >= 0
    lanes = np.broadcast_to(np.arange(n)[None], (m, n))
    assert np.all(d[lanes[chosen], pid[chosen]] < R[lanes[chosen]] + 1e-5)
    wt = np.where(chosen, w_true[lanes, np.maximum(pid, 0)]
                  / meas[0, np.maximum(pid, 0)], 0.0)
    est = (wt / np.maximum(pdf, 1e-30)).mean(0)
    empty = totals <= 0
    assert np.all(est[empty] == 0)
    rel = np.abs(est[~empty] - totals[~empty]) / totals[~empty]
    assert np.all(rel < 0.08), rel


def test_deep_trees_raise():
    """A tree too deep for the kernels' stack of 64 (depth + 4 entries)
    raises where the set is built."""
    verts, idx = _wavy_circle(4200)
    gp = TGS.make_geom_set(verts, idx, CPU, bvh=True)
    # a caterpillar of depth 61: node 2i has children 2i + 2 (internal)
    # and 2i + 1 (a leaf)
    M = 2 * 61 + 1
    left = np.full(M, -1, np.int32)
    right = np.full(M, -1, np.int32)
    for i in range(61):
        left[2 * i] = 2 * i + 2
        right[2 * i] = 2 * i + 1
    arrays = {k: np.asarray(v) for k, v in vars(gp).items()
              if isinstance(v, torch.Tensor)}
    arrays.update(left=left, right=right)
    with pytest.raises(ValueError, match="depth 61"):
        TGS.geom_set_from_arrays(arrays, CPU)
    # cut at depth 60, the deepest the stack holds: node 120 a leaf
    left[120] = right[120] = -1
    arrays.update(left=left[:121], right=right[:121])
    assert TGS.geom_set_from_arrays(arrays, CPU).depth == 60
