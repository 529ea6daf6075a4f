"""K13's lane-list form in the PyTorch port: the dense closest-segment
sweep over the lanes that K1 compacts from a mask.

``closest_point_dense(q, a, b, active)`` sweeps only the set lanes of
``active`` and gives every other lane distance +inf and prim 0.  On the
CPU its plain version runs (``chip_smoke.py`` holds the CUDA kernel to it
on the card, ids exact and distances bit-equal).  Here: the lane-list
plain form against the full plain form (bit-equal on the listed lanes,
the fixed result elsewhere) at no, every, a few lanes and at shared
vertices; the listed lanes against ``elaina_tpu``'s
``closest_point_dense_pallas`` in interpret mode (1e-5, ties as in
``tests/test_torch_dense.py``); ``_dense_dirichlet``, which now hands K13
the active lanes, against its unmasked route; and a whole depth step of
a no-grid scene with a Neumann box and a source, lane for lane against
the same step with K13 sweeping every lane.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.ops.pallas_queries import \
    closest_point_dense_pallas  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.ops import queries as K  # noqa: E402
from elaina_tpu_torch.solver import wost as W  # noqa: E402
from elaina_tpu_torch.utils import rng as RNG  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _loop(n, seed=0, r0=3.0, amp=0.8):
    """A closed wavy loop of n segments, vertices jittered from a seed."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * math.pi, n, endpoint=False)
    r = r0 + amp * np.sin(7 * t) + rng.uniform(-0.05, 0.05, n)
    verts = np.stack([r * np.cos(t), r * np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    return verts, idx


def _points(verts, n=600, seed=1):
    """Random points around the loop, then every vertex (a tie at d = 0
    between the two segments that share it)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-4.5, 4.5, (n, 2)),
                           verts]).astype(np.float32)


def _mask(case, n, n_rand):
    rng = np.random.default_rng(4)
    if case == "none":
        return np.zeros(n, bool)
    if case == "all":
        return np.ones(n, bool)
    if case == "few":
        m = np.zeros(n, bool)
        m[rng.choice(n, 7, replace=False)] = True
        return m
    m = np.zeros(n, bool)                          # "vertex": the ties
    m[n_rand::3] = True
    return m


@pytest.mark.parametrize("case", ["none", "all", "few", "vertex"])
def test_lane_list_plain_matches_full(case):
    """cnt = 0, cnt = N, a few lanes and lanes at shared vertices: the
    listed lanes bit-equal to the full form, the rest +inf and prim 0."""
    verts, idx = _loop(40)
    q = _points(verts)
    n = q.shape[0]
    m = _mask(case, n, 600)
    a, b = _t(verts[idx[:, 0]]), _t(verts[idx[:, 1]])
    d_full, p_full = K.closest_point_dense(_t(q), a, b)
    d, p = K.closest_point_dense(_t(q), a, b, _t(m))
    d, p, d_full, p_full = (x.numpy() for x in (d, p, d_full, p_full))
    np.testing.assert_array_equal(d[m], d_full[m])
    np.testing.assert_array_equal(p[m], p_full[m])
    assert np.isinf(d[~m]).all() and (p[~m] == 0).all()
    if case == "vertex":
        # vertex k ends segment k - 1 and starts segment k: the smaller wins
        k = np.flatnonzero(m) - 600
        assert (d[m] == 0).all()
        np.testing.assert_array_equal(p[m], np.where(k == 0, 0, k - 1))


def test_lane_list_matches_pallas():
    """The listed lanes against the TPU kernel in interpret mode: 1e-5,
    the same prim or one at the same distance (a tie whose last bit the
    XLA side's fused multiply-adds move)."""
    verts, idx = _loop(50)
    q = _points(verts, 700)
    m = np.random.default_rng(2).random(q.shape[0]) < 0.15
    a, b = verts[idx[:, 0]], verts[idx[:, 1]]
    dj, pj = (np.asarray(x) for x in closest_point_dense_pallas(
        jnp.asarray(q), jnp.asarray(a), jnp.asarray(b), interpret=True))
    dp, pp = (x.numpy() for x in K.closest_point_dense(_t(q), _t(a), _t(b),
                                                       _t(m)))
    np.testing.assert_allclose(dp[m], dj[m], rtol=TOL, atol=1e-6)
    other = m & (pp != pj)
    assert other.sum() <= 0.03 * m.sum()
    full = K.closest_point_dense_plain(_t(q), _t(a), _t(b))[0].numpy()
    np.testing.assert_array_equal(dp[other], full[other])


def _bench_scene(neumann=False, source=None):
    """bench.py's curve at 256 segments (no grid) scaled into a small
    box, with seeded colors; optionally in a 4-segment Neumann box."""
    verts = (S.lobed_curve(256) - 250.0) / 100.0
    n = len(verts)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    colors = np.random.default_rng(0).uniform(0, 1, (n, 2, 3))
    box = None
    if neumann:
        bv = np.array([[-3, -3], [3, -3], [3, 3], [-3, 3]], np.float32)
        bi = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], np.int32)
        box = (bv, bi, np.full((4, 2, 3), 0.25, np.float32))
    return P.scene_from_numpy(
        aabb_lo=[-3.5, -3.5], aabb_hi=[3.5, 3.5], device=CPU,
        dirichlet=(verts.astype(np.float32), idx, colors.astype(np.float32)),
        neumann=box, source=source)


def _lanes(n=3000, seed=9, eps=0.02):
    """Points in the box, a third of them within ~eps of the curve, and an
    active mask with ~15% of the lanes set (as on the bench square a few
    steps in)."""
    rng = np.random.default_rng(seed)
    verts = (S.lobed_curve(256) - 250.0) / 100.0
    k = rng.integers(0, 256, n)
    s = rng.uniform(0, 1, n)[:, None]
    near = verts[k] * (1 - s) + verts[(k + 1) % 256] * s
    q = rng.uniform(-2.9, 2.9, (n, 2))
    q[::3] = near[::3] + rng.normal(0, eps, (len(q[::3]), 2))
    return q.astype(np.float32), rng.random(n) < 0.15


def test_dense_dirichlet_matches_unmasked_route():
    """R_D, in_shell and the color on the active lanes equal those of the
    route that resolves every lane; in_shell is false elsewhere."""
    scene = _bench_scene()
    q, act = _lanes()
    eps = 0.02
    R_D, ins, col, need = W._dense_dirichlet(scene, _t(q), _t(act), eps)
    ones = torch.ones(len(q), dtype=torch.bool)
    R_all, ins_all, col_all, _ = W._dense_dirichlet(scene, _t(q), ones, eps)
    a = _t(act)
    assert torch.equal(need, a)
    assert torch.equal(R_D[a], R_all[a]) and torch.isinf(R_D[~a]).all()
    assert torch.equal(ins, ins_all & a) and ins.sum() > 20
    assert torch.equal(col[a], col_all[a])


def test_depth_step_matches_unmasked_route(monkeypatch):
    """One depth step of a no-grid scene with a Neumann box and a source,
    lane for lane: the same contributions and the same next walk state as
    the step with K13 sweeping every lane.  The inactive lanes' R_D =
    +inf is never read."""
    src = P.source_from_numpy(
        np.random.default_rng(3).uniform(0, 1, (16, 16, 3)), [-3.5, -3.5],
        [7.0 / 16, 7.0 / 16], CPU)
    scene = _bench_scene(neumann=True, source=src)
    q, act = _lanes(seed=10)
    eps = 0.02

    def step():
        st = W.init_walk_state(_t(q), _t(act))
        return W.wost_depth_step(scene, st, RNG.sample_generators(0, 0, CPU),
                                 eps)

    st1, c1, n1 = step()
    full = K.closest_point_dense
    monkeypatch.setattr(K, "closest_point_dense",
                        lambda q, a, b, active=None: full(q, a, b))
    st0, c0, n0 = step()
    assert int(n1) == int(n0) == act.sum()
    assert torch.equal(c1, c0) and (c1 != 0).any()
    for f in ("pos", "thp", "active", "on_neumann", "n_normal"):
        assert torch.equal(getattr(st1, f), getattr(st0, f)), f
