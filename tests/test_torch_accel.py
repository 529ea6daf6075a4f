"""``Problem.load_config(accel=...)`` and solves on the BVH route in the
PyTorch port.

The analytic scenes of ``chip_smoke.py`` ([3], [6]) cut finer, so that
every set passes CHUNKED_DENSE_MAX and its queries descend its trees (the
plain versions of B1-B4 here, the CPU's): the mixed square, u = (x + 1) /
2 (Dirichlet walls x = +-1, zero Neumann on y = +-1, 4,100 segments a
set), and the mixed cube of 33 x 33 squares a face.  Each point's mean
lies within 0.07 of u (at least 3 standard errors of its walks); the
square's per-sample means also within 4 combined standard errors of the
JAX package's BVH route on the same points.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.core.problem import Problem as JaxProblem  # noqa: E402
from elaina_tpu.solver import wost as WJ  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.solver.debug import trace_walk  # noqa: E402
from elaina_tpu_torch.solver.integrator import UniformIntegrator  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402

CPU = torch.device("cpu")
PER_SIDE = 2050          # segments a wall: 4,100 a set
PTS = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8]], np.float32)
SQUARE_NET = {"encoding": {"base_resolution": 4, "n_levels": 4,
                           "n_features_per_level": 2,
                           "per_level_scale": 1.5},
              "network": {"n_neurons": 32, "n_hidden_layers": 2}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU ops gain nothing
    from more, and in a parallel test run the OpenMP pool's waits stall
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walls(sides, n):
    """Open polylines along the square's sides (chip_smoke.square_side)."""
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    verts, idx = [], []
    for s in sides:
        a, b = corners[s], corners[(s + 1) % 4]
        base = len(verts)
        verts.extend(a + np.linspace(0, 1, n + 1)[:, None] * (b - a))
        idx.extend((base + i, base + i + 1) for i in range(n))
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def _write_polylines(path, verts, idx):
    with open(path, "w") as f:
        f.writelines(f"v {x:.7f} {y:.7f} 0\n" for x, y in verts)
        f.writelines(f"l {a + 1} {b + 1}\n" for a, b in idx)


@pytest.fixture(scope="module")
def square(tmp_path_factory):
    """The mixed square's scene entry (OBJs and colors on disk)."""
    root = tmp_path_factory.mktemp("square")
    dv, di = _walls((1, 3), PER_SIDE)
    nv, ni = _walls((0, 2), PER_SIDE)
    _write_polylines(root / "d.obj", dv, di)
    _write_polylines(root / "n.obj", nv, ni)
    u = (dv[:, 0] + 1.0) / 2.0
    np.savez(root / "c.npz", colors=np.repeat(
        np.repeat(u[:, None, None], 2, 1), 3, 2).astype(np.float32))
    return {"aabb": {"min": [-1.0, -1.0], "max": [1.0, 1.0]},
            "evaluation_grid": {"mData": {"pos": [0.0, 0.0], "scale": 1.0}},
            "mesh": {"dirichlet_path": str(root / "d.obj"),
                     "vertex_color_dirichlet_path": str(root / "c.npz"),
                     "neumann_path": str(root / "n.obj")}}


@pytest.fixture(scope="module")
def bvh_problem(square):
    return P.Problem(2, CPU, verbose=False).load_config(square, accel="bvh")


def test_load_config_routes(square, tmp_path, monkeypatch):
    """"bvh" builds no grid and gives the sets their trees; "grid" and
    "auto" give the grid route's scene; anything else raises.  d_stack
    and n_stack are the JAX Problem's; the stats and the hint file name
    the route."""
    monkeypatch.setattr(P, "GRID_MAX_RES", 32)
    bvh = P.Problem(2, CPU, verbose=False).load_config(
        square, cache_dir=str(tmp_path), accel="bvh")
    sc = bvh.scene
    assert sc.accel == "bvh" and bvh.stats["accel"] == "bvh"
    assert sc.d_grid is None and sc.n_sgrid is None and sc.n_bgrid is None
    d, n = sc.dirichlet.gs, sc.neumann.gs
    assert d.has_tree and d.node_measure is not None and d.sil_left is None
    assert n.has_tree and n.node_measure is not None
    assert n.sil_left is not None and n.sil_cone_cos is not None
    assert bvh.table_bytes()["neumann_tree"] == n.tree_bytes() > 0
    jp = JaxProblem(2, verbose=False).load_config(square, accel="bvh")
    assert (bvh.d_stack, bvh.n_stack) == (jp.d_stack, jp.n_stack)
    assert bvh.d_stack == d.depth + 4 and bvh.n_stack == n.depth + 4
    paths = {bvh._hint_path()}
    for accel in ("grid", "auto"):
        g = P.Problem(2, CPU, verbose=False).load_config(
            square, cache_dir=str(tmp_path), accel=accel)
        assert g.scene.accel == "grid" and g.stats["accel"] == "grid"
        assert g.scene.d_grid is not None and g.scene.n_sgrid is not None
        assert g.scene.n_bgrid is not None
        assert not g.scene.dirichlet.gs.has_tree
        assert not g.scene.neumann.gs.has_tree
        assert (g.d_stack, g.n_stack) == (jp.d_stack, jp.n_stack)
        paths.add(g._hint_path())
    assert len(paths) == 2
    with pytest.raises(ValueError, match="accel"):
        P.Problem(2, CPU, verbose=False).load_config(square, accel="kd")


def _solve(problem, reps, spp, depth, chunk=None, guided=False):
    lanes = torch.as_tensor(np.repeat(PTS, reps, axis=0))
    settings = IntegratorSettings(frameSize=(len(lanes), 1),
                                  samplesPerPixel=spp,
                                  maxWalkingDepth=depth, epsilonShell=0.02,
                                  **({"trainSppCount": spp // 2}
                                     if guided else {}))
    if guided:
        from elaina_tpu_torch.solver.guided import GuidedIntegrator

        integ = GuidedIntegrator(problem, settings, "unused", points=lanes)
        integ.reset_network(SQUARE_NET)
        integ.solve()
    else:
        integ = UniformIntegrator(problem, settings, "unused", points=lanes)
        integ.solve(chunk)
    u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(len(PTS), reps)
    return u, integ


@pytest.mark.parametrize("route", ["balanced", "per-sample", "guided"])
def test_mixed_square_on_the_bvh_route(bvh_problem, route):
    """Uniform on both routes, and guided (the balanced route, half the
    samples training), each point within 0.07 of u."""
    u, integ = _solve(bvh_problem, 192, 2, 32,
                      chunk=1 if route == "per-sample" else None,
                      guided=route == "guided")
    mean = u.mean(1)
    assert np.all(np.abs(mean - (PTS[:, 0] + 1) / 2) <= 0.07), mean
    assert integ.total_walk_steps > 0


def _jax_means(square, reps, spp, depth, eps):
    """The JAX package's BVH route, per sample, at PTS: (means, standard
    errors) over reps x spp walks of its depth step."""
    jp = JaxProblem(2, verbose=False).load_config(square, accel="bvh")
    pts = jnp.asarray(np.repeat(PTS, reps, axis=0))
    step = jax.jit(WJ.wost_depth_step, static_argnums=(3, 4, 5))
    sums = []
    for s in range(spp):
        state = WJ.init_walk_state(pts, jnp.ones((pts.shape[0],), bool))
        total = jnp.zeros((pts.shape[0], 3))
        key = jax.random.PRNGKey(s)
        for k in range(depth):
            state, c = step(jp.scene, state, jax.random.fold_in(key, k), eps,
                            jp.d_stack, jp.n_stack)
            total = total + c
        sums.append(np.asarray(total[:, 0]).reshape(len(PTS), reps))
    x = np.concatenate(sums, axis=1)
    return x.mean(1), x.std(1, ddof=1) / np.sqrt(x.shape[1])


def test_mixed_square_matches_jax(square, bvh_problem):
    """The square through the JAX package's ``load_config(accel="bvh")``
    and the port's, per sample at the same points: means within 4
    combined standard errors."""
    mj, sj = _jax_means(square, 96, 2, 32, 0.02)
    u, _ = _solve(bvh_problem, 96, 2, 32, chunk=1)
    mp = u.mean(1)
    sp = u.std(1, ddof=1) / np.sqrt(u.shape[1])
    assert np.all(np.abs(mp - mj) <= 4 * np.hypot(sp, sj)), (mp, mj)


def test_fine_cube_on_the_bvh_route(tmp_path):
    """[11c]'s cube (33 x 33 squares a face: 4,356 Dirichlet and 8,712
    Neumann triangles) on the BVH route at a small lane count (192 walks
    a point, depth 128): each point within 0.07 of u on the per-sample
    route."""
    scene = S.write_mixed_cube(str(tmp_path), 33)
    problem = P.Problem(3, CPU, verbose=False).load_config(scene,
                                                           accel="bvh")
    assert problem.scene.neumann.gs.sil_left is not None
    pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, -0.5], [-0.6, 0.3, 0.4]],
                   np.float32)
    reps = 192
    lanes = torch.as_tensor(np.repeat(pts, reps, axis=0))
    settings = IntegratorSettings(frameSize=(len(lanes), 1),
                                  samplesPerPixel=1, maxWalkingDepth=128,
                                  epsilonShell=0.02)
    integ = UniformIntegrator(problem, settings, "unused", points=lanes)
    integ.solve(1)
    u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(3, reps).mean(1)
    assert np.all(np.abs(u - (pts[:, 0] + 1) / 2) <= 0.07), u


def test_trace_walk_on_the_bvh_route(bvh_problem):
    """trace_walk with the JAX Problem's stacks traces a walk; a stack
    shorter than a descent of the set's tree raises."""
    scene = bvh_problem.scene
    out = trace_walk(scene, [0.2, 0.1], eps=0.02, max_depth=64,
                     d_stack=bvh_problem.d_stack,
                     n_stack=bvh_problem.n_stack)
    assert out and not out[-1]["active"] or len(out) == 64
    assert all(np.isfinite(e["contribution"]).all() for e in out)
    assert out[0]["pos"] == pytest.approx([0.2, 0.1])
    for kw in ({"d_stack": scene.dirichlet.gs.depth},
               {"n_stack": scene.neumann.gs.depth}):
        with pytest.raises(ValueError, match="stack"):
            trace_walk(scene, [0.2, 0.1], eps=0.02, **kw)
    assert json.dumps(out)          # plain Python values
