"""Guided Walk-on-Stars in 3D in the PyTorch port against
``elaina_tpu`` and the analytic solution.

(a) The tri-plane encoding (``nn/encoding.py``) against the JAX package's
``grid_encode`` at ``configs/bumpy3d_n.json``'s encoding (DenseGrid 8
levels x 4 features, base 8, scale 1.405: 46,149 rows at full width), on
random points and on every level's vertices, 0 and 1, values to 1e-5 and
table gradients to 1e-4 relative of the largest (a scatter-add in
PyTorch, a matmul in JAX).
(b) A 3D HashGrid (volumetric levels, dense below the hash cap and
hashed above it) against JAX's gather form, values and gradients.
(c) ``apply_network`` in 3D at bumpy3d_n's width with the JAX package's
weights carried across (``trainer_from_numpy``), to the bf16 boundary
bounds of ``tests/test_torch_guide_net.py``.
(d) ``guided_depth_step`` in 3D with per-lane depths, fed the JAX step's
own uniforms (its key splits): on the Dirichlet cube without a grid, and
on the mixed cube of ``tests/test_torch_slice3d.py`` with colored Neumann
faces, whose step takes the fused band step (K6; JAX in Pallas interpret
mode) on the guided direction.  The live mask and the records' slot counts
exactly; contributions, the next walk state and every record field to
1e-4.
(e) ``train_on_records`` on 3D records against JAX, to the bounds of
``tests/test_torch_guided.py``.
(f) ``tests/test_guided_3d.py::test_guided_3d_runs_and_trains`` in the
port, per-sample and on the balanced route: u = (x + 1) / 2 on the cube,
the lanes' mean within 0.12 of 0.5, the loss finite.
(g) A bumpy3d_3 guided config at 32^2 through ``run_expr`` on the CPU,
its film within 4 combined standard errors of the uniform run's on
>= 99% of pixel channels.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.nn import encoding as EJ  # noqa: E402
from elaina_tpu.nn import network as NJ  # noqa: E402
from elaina_tpu.solver import guided as GJ  # noqa: E402
from elaina_tpu.solver import wost as WJ  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.nn import encoding as ET  # noqa: E402
from elaina_tpu_torch.nn import network as NT  # noqa: E402
from elaina_tpu_torch.solver import guided as GT  # noqa: E402
from elaina_tpu_torch.solver import wost as TW  # noqa: E402
from elaina_tpu_torch.solver.distributions import n_dim_output  # noqa: E402
from elaina_tpu_torch.utils.rng import sample_generators  # noqa: E402
from tests.test_torch_guide_net import SMALL, _jax_params  # noqa: E402
from tests.test_torch_guided import TINY  # noqa: E402

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MGD = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _bumpy_net() -> dict:
    with open(os.path.join(REPO, "configs", "bumpy3d_n.json")) as f:
        return json.load(f)["network"]


def _encode_both(spec_j, spec_t, table, x, seed):
    """(port values, JAX values, port table gradient, JAX table gradient)
    of sum(encoding * w) for seeded weights w."""
    tt = _t(table).requires_grad_(True)
    got = ET.grid_encode(spec_t, tt, _t(x))
    w = np.random.default_rng(seed).normal(size=tuple(got.shape)).astype(
        np.float32)

    def loss(t):
        enc = EJ.grid_encode(spec_j, t, jnp.asarray(x))
        return jnp.sum(enc * w), enc

    (_, want), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(table))
    (gt,) = torch.autograd.grad((got * _t(w)).sum(), tt)
    return got.detach().numpy(), np.asarray(want), gt.numpy(), np.asarray(gj)


def test_triplane_encoding_matches_jax():
    conf = _bumpy_net()["encoding"]
    spec_j = EJ.make_grid_encoding(3, conf)
    spec = ET.make_grid_encoding(3, conf)
    assert tuple(spec) == tuple(spec_j) and spec.triplane
    assert spec.n_params == 46149 and spec.out_dim == 32
    table = np.random.default_rng(0).uniform(
        -1, 1, (spec.n_params, spec.n_features)).astype(np.float32)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.05, 1.05, (2048, 3)).astype(np.float32)
    # every level's vertices on each axis (the last one at pos == res:
    # cell res - 1 at frac 1 here, the tent weight 1 in JAX), 0 and 1
    verts = np.concatenate([np.arange(r + 1) / r for r in spec.resolutions]
                           + [[0.0, 1.0]]).astype(np.float32)
    on_vertex = rng.choice(verts, (1024, 3)).astype(np.float32)
    x = np.concatenate([x, on_vertex, [[0, 0, 0], [1, 1, 1], [0, 1, 0],
                                       [1, 0, 1]]]).astype(np.float32)
    got, want, gt, gj = _encode_both(spec_j, spec, table, x, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4,
                               atol=1e-4 * np.abs(gj).max())
    # a constant table gives 3 a feature (one a plane): the weights sum
    # to 1 on every plane
    ones = ET.grid_encode(spec, torch.ones((spec.n_params, 4)), _t(x))
    np.testing.assert_allclose(ones.numpy(), 3.0, rtol=1e-5)


def test_hashed_3d_encoding_matches_jax():
    conf = {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2,
            "base_resolution": 8, "per_level_scale": 2.0,
            "log2_hashmap_size": 10}
    spec_j = EJ.make_grid_encoding(3, conf)
    spec = ET.make_grid_encoding(3, conf)
    assert tuple(spec) == tuple(spec_j) and not spec.triplane
    assert spec.hashed[-1] and not spec.hashed[0]
    table = np.random.default_rng(3).uniform(
        -1, 1, (spec.n_params, spec.n_features)).astype(np.float32)
    x = np.random.default_rng(4).uniform(0, 1, (2048, 3)).astype(np.float32)
    x[:2] = [[0, 0, 0], [1, 1, 1]]
    got, want, gt, gj = _encode_both(spec_j, spec, table, x, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4,
                               atol=1e-4 * np.abs(gj).max())


def test_apply_network_3d_matches_jax_with_carried_weights():
    n_out = n_dim_output(3)
    spec_j = NJ.make_network(3, n_out, _bumpy_net())
    spec_t = NT.make_network(3, n_out, _bumpy_net())
    params = _jax_params(spec_j, 0, table_scale=1.0)
    x = np.random.default_rng(6).uniform(0, 1, (4096, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: NJ.apply_network(spec_j, p, x))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    tr = NT.trainer_from_numpy(params)
    got = NT.GuidingNetwork(spec_t, tr.params)(_t(x)).detach().numpy()
    assert got.shape == (4096, n_out)
    diff = np.abs(got - want)
    assert diff.max() <= 4e-3
    assert np.mean(diff <= 1e-5) >= 0.99
    back = NT.trainer_to_numpy(tr)
    for k in params:
        np.testing.assert_array_equal(back["params"][k], params[k])


# --------------------------------------------------------------------------- #
# (d) one guided depth step
# --------------------------------------------------------------------------- #


def _jax_uniforms(key, n, neumann: bool):
    """The uniforms a 3D guided step draws from ``key``: (k_sel, k_src,
    k_neu, k_uni, k_gui, k_walk) = split(key, 6); the uniform direction's
    sphere (z, phi) from split(split(k_uni)[0]) and, with a Neumann set,
    its hemisphere's from split(split(k_uni)[1]); the route from k_sel;
    the mixture sample's component from split(k_gui)[0] and its vMF's two
    from split(split(k_gui)[1]); the fused band step's in-ball uniforms
    (N,) and (N, 2) from split(k_neu)."""
    k_sel, _, k_neu, k_uni, k_gui, _ = jax.random.split(key, 6)

    def pair(k):
        a, b = jax.random.split(k)
        return [jax.random.uniform(a, (n,)), jax.random.uniform(b, (n,))]

    k_sph, k_hem = jax.random.split(k_uni)
    k_s, k_d = jax.random.split(k_gui)
    feed = {"uniform": pair(k_sph) + (pair(k_hem) if neumann else []),
            "route": [jax.random.uniform(k_sel, (n,))],
            "guide": [jax.random.uniform(k_s, (n,))] + pair(k_d)}
    if neumann:
        k_a, k_b = jax.random.split(k_neu)
        feed["neumann"] = [jax.random.uniform(k_a, (n,)),
                           jax.random.uniform(k_b, (n, 2))]
    return feed


def _dirichlet_cube():
    """tests/test_guided_3d.py's cube: every face Dirichlet, u = (x + 1)
    / 2, no grid on either side."""
    from tests.test_wost_3d import _colors_from_fn, _cube_boundary, _scene3
    from elaina_tpu.core.problem import Boundary
    from elaina_tpu.geometry.geomset import make_geom_set

    verts, tris = _cube_boundary(n=2)
    colors = _colors_from_fn(verts, lambda v: (v[0] + 1.0) / 2.0)
    scene_j = _scene3(dirichlet=Boundary(gs=make_geom_set(verts, tris)[0],
                                         colors=jnp.asarray(colors)))
    scene_t = P.scene_from_numpy(aabb_lo=[-1] * 3, aabb_hi=[1] * 3,
                                 device=CPU, dirichlet=(verts, tris, colors))
    return scene_j, scene_t


def _mixed_cube():
    """The mixed cube of tests/test_torch_slice3d.py with seeded colors on
    its Neumann faces, so that the Neumann term contributes."""
    from tests.test_torch_slice3d import _cube_sets, cube_scene_pair

    nv = _cube_sets()[3]
    return cube_scene_pair(np.random.default_rng(8).uniform(
        0, 1, (len(nv), 2, 3)))


def _lanes(n: int, neumann: bool, seed: int = 4):
    """Walk states inside the cube (a quarter of them, with a Neumann set,
    on the y = +-1 and z = +-1 faces with inward normals), per-lane walk
    depths on both sides of the guided depth and of TRAIN_DEPTH_CAP, and
    seeded records with slot counts 0-3."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    on = np.zeros(n, bool)
    nrm = np.zeros((n, 3), np.float32)
    # a fifth of the lanes within the shell of a Dirichlet face x = +-1
    near = rng.random(n) < 0.2
    pos[near, 0] = np.sign(pos[near, 0]) * 0.99
    if neumann:
        on = ~near & (rng.random(n) < 0.3)
        axis = rng.integers(1, 3, n)
        side = rng.choice([-1.0, 1.0], n)
        pos[on, axis[on]] = side[on]
        nrm[on, axis[on]] = -side[on]
    st = dict(pos=pos, thp=rng.uniform(0.5, 2, n).astype(np.float32),
              active=rng.random(n) < 0.85, on_neumann=on, n_normal=nrm)
    wstep = rng.integers(0, 12, n).astype(np.int32)
    wstep[:8] = 0
    R = GT.MAX_TRAIN_DEPTH
    d = rng.normal(size=(R, n, 3))
    nr = rng.normal(size=(R, n, 3))
    rec = dict(pos=rng.uniform(-1, 1, (R, n, 3)).astype(np.float32),
               dir=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
                   np.float32),
               dir_pdf=rng.uniform(0.05, 1, (R, n)).astype(np.float32),
               thp=rng.uniform(0.5, 2, (R, n)).astype(np.float32),
               sol=rng.uniform(0, 1, (R, n, 3)).astype(np.float32),
               on_neumann=rng.random((R, n)) < 0.3,
               normal=(nr / np.linalg.norm(nr, axis=-1,
                                           keepdims=True)).astype(np.float32),
               cur=rng.integers(0, 4, n).astype(np.int32))
    return st, wstep, rec


@pytest.mark.parametrize("case", ["dirichlet", "fused_neumann"])
def test_guided_depth_step_3d_matches_jax(case, monkeypatch):
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    neumann = case == "fused_neumann"
    scene_j, scene_t = _mixed_cube() if neumann else _dirichlet_cube()
    assert TW.fused_band_available(scene_t) == neumann
    assert WJ.fused_band_available(scene_j) == neumann
    eps = 0.02
    spec_j = NJ.make_network(3, n_dim_output(3), TINY)
    spec_t = NT.make_network(3, n_dim_output(3), TINY)
    p = _jax_params(spec_j, 7, table_scale=1.0)
    n = 64
    st, wstep, rec = _lanes(n, neumann)
    fresh = st["active"] & (wstep == 0)
    rd0 = TW.compute_step0(scene_t, _t(st["pos"]), _t(st["active"]),
                           eps)[0].numpy()
    key = jax.random.PRNGKey(9)
    st_j, rec_j, c_j = jax.jit(lambda p, st, rec, key, wstep, step0:
                               GJ.guided_depth_step(
        scene_j, spec_j, p, st, rec, key, wstep, True, True, 0.5, MGD,
        eps=eps, d_stack=32, n_stack=32, step0=step0))(
        {k: jnp.asarray(v) for k, v in p.items()},
        WJ.WalkState(**{k: jnp.asarray(v) for k, v in st.items()}),
        GJ.WalkRecords(**{k: jnp.asarray(v) for k, v in rec.items()}), key,
        jnp.asarray(wstep), (jnp.asarray(fresh), jnp.asarray(rd0)))

    gens = sample_generators(0, 0, CPU)
    feed = {id(gens[k]): [_t(u) for u in v]
            for k, v in _jax_uniforms(key, n, neumann).items()}
    rand = torch.rand
    fused_calls = []
    walk_fused = TW._neumann_walk_fused

    def fed(*size, generator=None, **kw):
        out = feed[id(generator)].pop(0)
        shape = size[0] if len(size) == 1 else size
        assert tuple(out.shape) == tuple(np.atleast_1d(shape))
        return out

    def spy(*args, guided=None, **kw):
        fused_calls.append(guided is not None)
        return walk_fused(*args, guided=guided, **kw)

    monkeypatch.setattr(GT, "_neumann_walk_fused", spy)
    monkeypatch.setattr(torch, "rand", fed)
    st_t, rec_t, c_t, _ = GT.guided_depth_step(
        scene_t, spec_t, NT.trainer_from_numpy(p).params,
        GT.guide_box(scene_t, CPU),
        TW.WalkState(**{k: _t(v) for k, v in st.items()}),
        GT.WalkRecords(**{k: _t(v) for k, v in rec.items()}), gens,
        _t(wstep), True, True, 0.5, MGD, eps=eps,
        step0=(_t(fresh), _t(rd0)))
    monkeypatch.setattr(torch, "rand", rand)
    assert not any(feed.values())
    assert fused_calls == ([True] if neumann else [])

    live = st_t.active.numpy()
    np.testing.assert_array_equal(live, np.asarray(st_j.active))
    assert 0 < live.sum() < st["active"].sum()
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4,
                               atol=1e-4)
    for name in ("pos", "thp", "n_normal"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(),
                                   np.asarray(getattr(st_j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(st_t.on_neumann.numpy(),
                                  np.asarray(st_j.on_neumann))
    for name in ("cur", "on_neumann"):
        np.testing.assert_array_equal(getattr(rec_t, name).numpy(),
                                      np.asarray(getattr(rec_j, name)),
                                      err_msg=name)
    for name in ("pos", "dir", "dir_pdf", "thp", "sol", "normal"):
        np.testing.assert_allclose(getattr(rec_t, name).numpy(),
                                   np.asarray(getattr(rec_j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # the lanes below the guided depth moved off the uniform pdf; those
    # past it kept it
    deep = live & (wstep >= MGD) & ~st["on_neumann"]
    shallow = live & (wstep < MGD)
    thp0 = st["thp"]
    np.testing.assert_allclose(st_t.thp.numpy()[deep], thp0[deep],
                               rtol=1e-6)
    assert (np.abs(st_t.thp.numpy()[shallow] - thp0[shallow])
            > 1e-3 * thp0[shallow]).any()
    if neumann:
        assert st_t.on_neumann.numpy()[live].any()
        assert (c_t.numpy()[live] < 0).any()     # the Neumann term
        assert (st["on_neumann"] & live & (wstep < MGD)).any()


def test_train_on_records_3d_matches_jax():
    spec_j = NJ.make_network(3, n_dim_output(3), SMALL)
    spec_t = NT.make_network(3, n_dim_output(3), SMALL)
    tr_j = NJ.init_trainer(jax.random.PRNGKey(42), spec_j)
    p0 = {k: np.asarray(v) for k, v in tr_j.params.items()}
    _, _, rec = _lanes(2048, True, seed=5)
    rec["pos"] = rec["pos"] * 1.05

    class BoxScene:
        dim = 3
        aabb_lo = jnp.asarray([-1.0] * 3)
        aabb_hi = jnp.asarray([1.0] * 3)

    tr_j2, m_j = GJ.train_on_records(
        tr_j, spec_j, NJ.AdamConfig(), BoxScene(),
        GJ.WalkRecords(**{k: jnp.asarray(v) for k, v in rec.items()}),
        batch_size=4096, n_batches=2)
    box = GT.GuideBox(_t([-1.0] * 3), _t([1.0] * 3))
    tr_t2, m_t = GT.train_on_records(
        NT.trainer_from_numpy(p0), spec_t, NT.AdamConfig(), box,
        GT.WalkRecords(**{k: _t(v) for k, v in rec.items()}),
        batch_size=4096, n_batches=2)
    got = NT.trainer_to_numpy(tr_t2)
    assert got["count"] == int(tr_j2.opt.count) == 2
    assert float(m_t) == pytest.approx(float(m_j), rel=1e-4)
    for k in p0:
        assert np.abs(np.asarray(tr_j2.params[k]) - p0[k]).max() > 1e-3, k
        for field, tree, tol in (("params", tr_j2.params, 2e-4),
                                 ("ema_params", tr_j2.ema_params, 2e-5)):
            diff = np.abs(got[field][k] - np.asarray(tree[k]))
            assert np.mean(diff <= tol) >= 0.99, (field, k)
        for field, tree in (("mu", tr_j2.opt.mu), ("nu", tr_j2.opt.nu)):
            want = np.asarray(tree[k])
            gap = np.abs(got[field][k] - want).max() / np.abs(want).max()
            assert gap <= 0.07, (field, k, gap)


# --------------------------------------------------------------------------- #
# (f), (g) whole solves
# --------------------------------------------------------------------------- #


PTS = np.random.default_rng(0).uniform(-0.7, 0.7, (32, 3)).astype(np.float32)


@pytest.mark.parametrize("route", ["per_sample", "balanced"])
def test_guided_3d_runs_and_trains(route):
    """tests/test_guided_3d.py in the port: 8 samples (each trains; the
    balanced route: 4 of 8) at 32 points of the Dirichlet cube, depth 12,
    eps 0.05, the tiny network: finite, the lanes' mean within 0.12 of
    0.5, the loss finite and the optimizer stepped."""
    scene = _dirichlet_cube()[1]
    if route == "per_sample":
        spec = NT.make_network(3, n_dim_output(3), TINY)
        trainer = NT.init_trainer(spec, CPU)
        box = GT.guide_box(scene, CPU)
        total = torch.zeros((32, 3))
        losses = []
        for s in range(8):
            contrib, records, _, _, _ = GT.run_one_guided_sample(
                scene, spec, trainer.ema_params, box, _t(PTS),
                torch.ones(32, dtype=torch.bool),
                sample_generators(1, s, CPU), True, True, 0.5, 10,
                eps=0.05, max_depth=12)
            total += contrib
            trainer, metric = GT.train_on_records(
                trainer, spec, NT.AdamConfig(), box, records, batch_size=64,
                n_batches=1)
            losses.append(float(metric))
        u = (total / 8).numpy()
        count = int(trainer.opt.count)
    else:
        problem = P.Problem(3, CPU, verbose=False)
        problem.scene = scene
        settings = IntegratorSettings(frameSize=(32, 1), samplesPerPixel=8,
                                      maxWalkingDepth=12, epsilonShell=0.05,
                                      trainSppCount=4)
        integ = GT.GuidedIntegrator(problem, settings, "unused",
                                    points=_t(PTS))
        integ.reset_network(TINY)
        integ.solve()
        u = integ.films["SOLUTION"].pixels()[0]
        losses, count = integ.loss_history, int(integ.trainer.opt.count)
        assert integ.balance_rounds["train"] and integ.balance_rounds["guide"]
    assert np.isfinite(u).all()
    assert abs(u[:, 0].mean() - 0.5) < 0.12
    assert losses and np.isfinite(losses).all() and count > 0


def test_guided_3d_cli_matches_uniform(tmp_path, monkeypatch):
    """bumpy3d_quick's scene (bumpy3d_3.obj, 1,280 triangles) at 32^2,
    depth 256, 8 samples, guided (4 of them train; bumpy3d_n's integrator
    settings and network) and uniform, through ``run_expr`` on the CPU on
    the balanced route: result.json holds the guided keys and the films
    agree within 4 combined standard errors on >= 99% of pixel channels.
    The grids are capped at 16 cells (``GRID_MAX_RES``), whose FinePack
    bounds slow the walks near the surface: at depth 64 the guided step
    (no 0.99 shrink of the star) and the uniform one would meet the cap
    on different shares of their walks."""
    from elaina_tpu_torch.exec import run_expr
    from elaina_tpu_torch.solver import integrator as I

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(P, "GRID_MAX_RES", 16)
    with open(os.path.join(REPO, "configs", "bumpy3d_n.json")) as f:
        conf_n = json.load(f)
    conf_n["base_path"] = str(tmp_path / "exp") + "/"
    conf_n["scene"]["mesh"] = {
        "dirichlet_path": os.path.join(REPO, "configs", "data",
                                       "bumpy3d_3.obj"),
        "vertex_color_dirichlet_path": os.path.join(
            REPO, "configs", "data", "bumpy3d_3_colors.npz")}
    conf_n["integrator"]["setting"].update(
        frameSize=[32, 32], samplesPerPixel=8, trainSppCount=4,
        maxWalkingDepth=128)
    conf_n["network"].update(TINY)
    conf_u = json.loads(json.dumps(conf_n))
    conf_u["exp_name"] = "bumpy3d_u"
    conf_u["integrator"]["type"] = "uniform"
    del conf_u["network"]
    made = []
    init = I.BaseIntegrator.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(I.BaseIntegrator, "__init__", record)
    results = []
    for conf in (conf_n, conf_u):
        path = tmp_path / (conf["exp_name"] + ".json")
        path.write_text(json.dumps(conf))
        results.append(run_expr(str(path), device="cpu"))
    rn, ru = results
    assert np.isfinite(rn["loss_history"]).all() and rn["loss_history"]
    ps = rn["phase_stats"]
    assert ps["train_steps"] + ps["guide_steps"] == rn["walk_steps"] > 0
    assert "loss_history" not in ru
    assert os.path.exists(tmp_path / "exp" / "bumpy3d_n" / "solution.exr")
    gi, ui = made
    assert isinstance(gi, GT.GuidedIntegrator) and gi._net_trained
    a, b = ((i.sum / i.spp).numpy() for i in (gi, ui))
    assert np.isfinite(a).all()
    se = np.hypot(gi.standard_error(), ui.standard_error())
    within = np.abs(a - b) <= 4 * se + 1e-6
    assert within.mean() >= 0.99, within.mean()


def test_neumann3d_n_config(tmp_path):
    """``utils/scenes.write_neumann3d_n``: neumann3d_u's scene, channels
    and exports with bumpy3d_n's guided settings and network, the samples
    given, data in this checkout; ``write_config_copy`` of bumpy3d_n
    with its training samples given."""
    from elaina_tpu_torch.core.config import ExperimentConfig
    from elaina_tpu_torch.utils import scenes as S

    cfg = ExperimentConfig.from_file(S.write_neumann3d_n(str(tmp_path), 8,
                                                         3))
    with open(os.path.join(REPO, "configs", "neumann3d_u.json")) as f:
        shipped = json.load(f)
    assert cfg.integrator_type == "guided" and cfg.dimensionality == 3
    assert cfg.exp_name == "neumann3d_n"
    assert cfg.network == _bumpy_net()
    assert sorted(cfg.channels) == sorted(shipped["integrator"]["channels"])
    s = cfg.settings
    assert (s.samplesPerPixel, s.trainSppCount, s.maxWalkingDepth,
            s.maxGuidedDepthInGuidingPhase,
            s.uniformFractionInTrainingPhase) == (8, 3, 64, 10, 0.5)
    for path in cfg.scene["mesh"].values():
        assert os.path.exists(path)
    assert set(cfg.scene["mesh"]) == set(shipped["scene"]["mesh"])
    copy = ExperimentConfig.from_file(S.write_config_copy(
        str(tmp_path), "bumpy3d_n", 8, 2))
    assert (copy.settings.samplesPerPixel, copy.settings.trainSppCount,
            copy.integrator_type) == (8, 2, "guided")
