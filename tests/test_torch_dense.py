"""Dirichlet sets without a candidate grid in the PyTorch port, against
``elaina_tpu``.

K13 ``closest_point_dense_pallas`` (``elaina_tpu/ops/pallas_queries.py``,
interpret mode) against the port's ``closest_point_dense``, which takes
its plain PyTorch version on CPU tensors (``chip_smoke.py`` holds the CUDA
kernel to it on the card); ``geometry/queries.closest_point`` against the
JAX package's at every branch size (2D: dense, chunked, BVH on the JAX
side, K13 on the port's; 3D: dense and chunked on both); ``_separate``
without a grid lane for lane; ``Problem``'s routing at
``GRID_ACCEL_MIN_PRIMS``; a no-grid scene through both CLIs within Monte
Carlo error; and ``run_expr``'s explicit device.  Inputs are made with
numpy from a seed.  Distances agree to 1e-5 (rtol and atol: the same
float32 operations, but XLA contracts products and sums into fused
multiply-adds, which the port's -fmad=false kernels and its plain versions
do not); prim ids exactly, except at a tie: a point whose nearest point is
a vertex is as near to both segments that share it, and there the last
bit of the two distances, which the contraction moves, picks the winner
(about 1% of random points around a jagged loop).  Exactly on a vertex
both distances are 0 and the smaller index wins on both sides.
"""

import json
import math
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry import queries as QJ  # noqa: E402
from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu.ops.pallas_queries import \
    closest_point_dense_pallas  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.geometry import geomset as TGS  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.ops import queries as K  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU ops gain nothing
    from more, and in a parallel test run the OpenMP pool's waits stall
    them (the no-grid CLI test took ~500 s there, 11 s on one thread)."""
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


def _soup(n_tri, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    offs = rng.uniform(-0.4, 0.4, (n_tri, 3, 3)).astype(np.float32)
    return ((centers[:, None] + offs).reshape(-1, 3),
            np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3))


def _check_closest(dp, pp, dj, pj, d_all):
    """Distances within TOL; the same prim, or one at the same distance
    (a tie)."""
    np.testing.assert_allclose(dp, dj, rtol=TOL, atol=TOL)
    other = pp != pj
    lane = np.arange(len(pp))
    np.testing.assert_allclose(d_all[lane[other], pp[other]],
                               d_all[lane[other], pj[other]], rtol=TOL,
                               atol=TOL)
    assert other.mean() < 0.03


def _seg_distances(q, verts, idx):
    """All (N, P) point-segment distances in float64."""
    a = verts[idx[:, 0]].astype(np.float64)[None]
    e = verts[idx[:, 1]].astype(np.float64)[None] - a
    w = q.astype(np.float64)[:, None] - a
    t = np.clip((w * e).sum(-1) / np.maximum((e * e).sum(-1), 1e-30), 0, 1)
    return np.linalg.norm(w - t[..., None] * e, axis=-1)


def test_closest_point_dense_plain_matches_pallas():
    """K13's plain version against the TPU kernel in interpret mode, on
    random points and on every vertex of the loop, where the two segments
    that share it tie at distance 0 (the smallest index wins)."""
    verts, idx = _loop(50)
    rng = np.random.default_rng(1)
    q = np.concatenate([rng.uniform(-4.5, 4.5, (700, 2)), verts,
                        verts + 1e-3]).astype(np.float32)
    a, b = verts[idx[:, 0]], verts[idx[:, 1]]
    dj, pj = (np.asarray(x) for x in closest_point_dense_pallas(
        jnp.asarray(q), jnp.asarray(a), jnp.asarray(b), interpret=True))
    dp, pp = (x.numpy() for x in K.closest_point_dense(_t(q), _t(a), _t(b)))
    np.testing.assert_allclose(dp, dj, rtol=TOL, atol=1e-6)
    _check_closest(dp, pp, dj, pj, _seg_distances(q, verts, idx))
    on_vertex = slice(700, 750)
    np.testing.assert_array_equal(pp[on_vertex], pj[on_vertex])
    assert (dp[on_vertex] == 0).all()
    # vertex k is the end of segment k - 1 and the start of segment k
    want = np.where(np.arange(50) == 0, 0, np.arange(50) - 1)
    np.testing.assert_array_equal(pp[on_vertex], want)


def test_closest_point_dense_refuses_bad_inputs():
    q = torch.zeros((4, 2))
    seg = torch.zeros((3, 2))
    with pytest.raises(ValueError):
        K.closest_point_dense(q[:, :1].contiguous(), seg, seg)
    with pytest.raises(TypeError):
        K.closest_point_dense(q.double(), seg, seg)
    with pytest.raises(ValueError):
        K.closest_point_dense(q, torch.zeros((0, 2)), torch.zeros((0, 2)))


@pytest.mark.parametrize("dim,n_prims", [(2, 50), (2, 300), (2, 2048),
                                         (3, 50), (3, 300)])
def test_closest_point_matches_jax(dim, n_prims):
    """The port's closest_point and closest_point_detail against the JAX
    package's: 2D at its dense (50), chunked (300) and BVH (2,048) branch
    sizes, where the port runs K13 at every size; 3D at the dense and
    chunked sizes, which the port runs as the JAX package does."""
    rng = np.random.default_rng(n_prims)
    if dim == 2:
        verts, idx = _loop(n_prims, seed=n_prims)
        q = rng.uniform(-4.5, 4.5, (1500, 2)).astype(np.float32)
    else:
        verts, idx = _soup(n_prims)
        q = rng.uniform(-2.5, 2.5, (600, 3)).astype(np.float32)
    gj = make_geom_set(verts, idx)[0]
    gp = TGS.make_geom_set(verts, idx, CPU)
    dj, pj, uvj, sj = (np.asarray(x) for x in QJ.closest_point_detail(
        gj, jnp.asarray(q)))
    dp, pp, uvp, sp = (x.numpy() for x in QT.closest_point_detail(gp, _t(q)))
    if dim == 2:
        d_all = _seg_distances(q, verts, idx)
    else:
        from elaina_tpu_torch.geometry.primitives import prim_closest_point
        d_all = prim_closest_point(3, _t(q)[:, None, :], tuple(
            _t(verts[idx[:, k]])[None] for k in range(3)))[0].numpy()
    _check_closest(dp, pp, dj, pj, d_all)
    same = pp == pj
    np.testing.assert_allclose(uvp[same], uvj[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(sp[same], sj[same])


def _bench_scene_arrays(segments=256):
    """bench.py's curve cut into ``segments`` (the scenes module's
    lobed curve) scaled into a small box, with seeded colors."""
    verts = (S.lobed_curve(segments) - 250.0) / 100.0
    n = len(verts)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    colors = np.random.default_rng(0).uniform(0, 1, (n, 2, 3))
    return verts.astype(np.float32), idx, colors.astype(np.float32)


def test_separate_without_grid_matches_jax():
    """``_separate`` on a 256-segment Dirichlet set without a grid, lane
    for lane against the JAX package's (its ``dirichlet_distance_masked``
    without a grid): in-shell lanes, R_D, R_B and the in-shell colors on
    the active lanes.  K13 sweeps only those; the port's R_D is +inf on
    the others (dead walks: the step reads nothing there)."""
    from elaina_tpu.core.problem import Boundary, Scene
    from elaina_tpu.solver import wost as WJ
    from elaina_tpu_torch.solver import wost as WT

    verts, idx, colors = _bench_scene_arrays()
    eps = 0.01
    gs_j = make_geom_set(verts, idx)[0]
    scene_j = Scene(dirichlet=Boundary(gs=gs_j, colors=jnp.asarray(colors)),
                    neumann=None, d_grid=None, source=None,
                    aabb_lo=jnp.asarray([-3.0, -3.0]),
                    aabb_hi=jnp.asarray([3.0, 3.0]), dim=2,
                    source_intensity=1.0, dirichlet_intensity=1.0,
                    neumann_intensity=1.0)
    scene_p = P.scene_from_numpy(aabb_lo=[-3, -3], aabb_hi=[3, 3],
                                 device=CPU, dirichlet=(verts, idx, colors))
    assert scene_p.d_grid is None
    rng = np.random.default_rng(9)
    n = 2048
    # half the lanes within ~eps of the curve, so the shell test fires
    k = rng.integers(0, len(idx), n)
    s = rng.uniform(0, 1, n)[:, None]
    near = verts[idx[k, 0]] * (1 - s) + verts[idx[k, 1]] * s
    q = rng.uniform(-2.8, 2.8, (n, 2))
    q[::2] = near[::2] + rng.normal(0, eps, (n // 2, 2))
    q = q.astype(np.float32)
    act = np.arange(n) % 5 != 0
    in_j, RB_j, col_j, RD_j = (np.asarray(a) for a in WJ._separate(
        scene_j, WJ.init_walk_state(jnp.asarray(q), jnp.asarray(act)), eps,
        48, shrink=True))
    in_p, RB_p, col_p, RD_p, need = (a.numpy() for a in WT._separate(
        scene_p, WT.init_walk_state(_t(q), _t(act)), eps, shrink=True))
    np.testing.assert_array_equal(need, act)
    assert (in_p & act).sum() > 100
    np.testing.assert_array_equal(in_p & act, in_j & act)
    np.testing.assert_allclose(RD_p[act], RD_j[act], rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(RB_p[act], RB_j[act], rtol=TOL, atol=1e-6)
    assert np.isinf(RD_p[~act]).all()
    np.testing.assert_allclose(col_p[in_p & act], col_j[in_p & act],
                               rtol=TOL, atol=1e-6)


def test_problem_routes_dirichlet_sets_by_size(tmp_path, monkeypatch):
    """GRID_ACCEL_MIN_PRIMS = 256 prims take no candidate grid, 257 a grid
    with its coordinate table (elaina_tpu/core/problem.py:357)."""
    monkeypatch.setattr(P, "GRID_MAX_RES", 32)
    for n, has_grid in ((256, False), (257, True)):
        path = S.write_scene(str(tmp_path), 1, segments=n, frame=4)
        with open(path) as f:
            conf = json.load(f)
        problem = P.Problem(2, CPU, verbose=False).load_config(conf["scene"])
        g = problem.scene.d_grid
        assert (g is not None) == has_grid, n
        assert problem.scene.dirichlet.gs.n_prims == n
        if has_grid:
            assert g.coords is not None
            assert g.cand.shape[1] == P.grid_size_for(n)[0]


def test_run_expr_needs_a_device(tmp_path, monkeypatch):
    """Without a visible card, run_expr and the CLI raise unless asked for
    the CPU: no quiet CPU run."""
    from elaina_tpu_torch import __main__ as cli
    from elaina_tpu_torch.exec import run_expr

    path = S.write_scene(str(tmp_path), 1, segments=256, frame=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run_expr(path), lambda: cli.main(["run", path])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with pytest.raises(SystemExit):
        cli.main(["run", path, "--device", "tpu"])
    result = run_expr(path, device="cpu")
    assert result["device"] == "cpu" and result["walk_steps"] > 0
    assert cli.main(["run", path, "--device", "cpu"]) == 0


def test_cli_matches_jax_without_grid(tmp_path, monkeypatch):
    """bench.py's curve at 256 segments (no grid) in the 4-segment box,
    through both CLIs at 16^2 and 24 spp: the images agree within their
    combined Monte Carlo error, and every live lane-step of the port is
    resolved exactly."""
    from elaina_tpu.exec import run_expr as run_jax
    from elaina_tpu.output.image_io import read_exr
    from elaina_tpu_torch.exec import run_expr

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    spp = 24
    path = S.write_scene(str(tmp_path), spp, segments=256, frame=16)
    conf = json.loads(open(path).read())
    conf["integrator"]["setting"].update(saveSppMetricsDuration=1,
                                         saveSppMetricsUntil=spp)
    runs = {}
    for name, run in (("jax", run_jax),
                      ("port", partial(run_expr, device="cpu"))):
        conf["exp_name"] = name
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(conf))
        result = run(str(p))
        out = tmp_path / "exp" / name
        means = np.stack([read_exr(str(out / "frames" / f"{i}.exr"))
                          [..., :3].astype(np.float64) for i in range(spp)])
        k = np.arange(1, spp + 1, dtype=np.float64)[:, None, None, None]
        runs[name] = np.diff(means * k, axis=0, prepend=0.0)
        if name == "port":
            assert result["resolved_lanes"] == result["walk_steps"] > 0
            assert "cand" not in result["table_bytes"]
    mp, mj = runs["port"].mean(0), runs["jax"].mean(0)
    var = (runs["port"].var(0, ddof=1) + runs["jax"].var(0, ddof=1)) / spp
    assert np.isfinite(mp).all() and mp.max() > 0.1
    within = np.abs(mp - mj) <= 4.0 * np.sqrt(var) + 1e-5
    assert within.mean() >= 0.99, within.mean()
    se_mean = np.sqrt(var.sum()) / var.size
    assert abs(mp.mean() - mj.mean()) <= 3.0 * se_mean
