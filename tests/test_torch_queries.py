"""Neumann-set queries, Green's functions, frames and samplers of the
PyTorch port against ``elaina_tpu``.

The deterministic functions get identical inputs (made with numpy from a
seed) on both sides.  ``sample_in_ball``'s pdf goes through ``log``, where
XLA's CPU version carries about 1e-4 relative error, and log(R / d) is
ill-conditioned for a prim at the ball's rim: its tolerance is that floor
plus the lane's conditioning (``_pdf_tolerance``).  The
random samplers draw from different generators on the two sides, so they
are compared by their moments.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry import queries as Q  # noqa: E402
from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu.solver import green as GJ  # noqa: E402
from elaina_tpu.solver import sampling as SJ  # noqa: E402
from elaina_tpu.utils import mathops as MJ  # noqa: E402
from elaina_tpu_torch.geometry import geomset as TGS  # noqa: E402
from elaina_tpu_torch.geometry import queries as TQ  # noqa: E402
from elaina_tpu_torch.solver import green as GT  # noqa: E402
from elaina_tpu_torch.solver import sampling as ST  # noqa: E402
from elaina_tpu_torch.utils import mathops as MT  # noqa: E402
from elaina_tpu_torch.utils.rng import sample_generators  # noqa: E402

CPU = torch.device("cpu")


def _box(half=1.0, n_per_side=1):
    """Closed CCW box polyline [-half, half]^2 (the slice's Neumann set)."""
    c = np.array([[-half, -half], [half, -half], [half, half],
                  [-half, half]], np.float32)
    pts = []
    for s in range(4):
        a, b = c[s], c[(s + 1) % 4]
        for i in range(n_per_side):
            pts.append(a + (b - a) * i / n_per_side)
    verts = np.asarray(pts, np.float32)
    n = len(verts)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n], -1).astype(np.int32)
    return verts, idx


def _open_polyline(n=40, seed=5):
    """An open zig-zag polyline: open ends make 'always' silhouettes."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.5, 1.5, n + 1)
    y = 0.3 * np.sin(3 * x) + rng.uniform(-0.1, 0.1, n + 1)
    verts = np.stack([x, y], -1).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(1, n + 1)], -1).astype(np.int32)
    return verts, idx


SETS = {"box": _box(), "box16": _box(n_per_side=4), "open": _open_polyline()}


@pytest.fixture(scope="module", params=sorted(SETS))
def gsets(request):
    verts, idx = SETS[request.param]
    return make_geom_set(verts, idx)[0], TGS.make_geom_set(verts, idx, CPU)


def test_geomset_matches_jax(gsets):
    gj, gp = gsets
    np.testing.assert_allclose(gp.prim_normal.numpy(),
                               np.asarray(gj.prim_normal), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(gp.prim_measure.numpy(),
                               np.asarray(gj.prim_measure), rtol=1e-6)
    for name in ("sil_p0", "sil_n1", "sil_n2", "sil_always"):
        np.testing.assert_array_equal(getattr(gp, name).numpy(),
                                      np.asarray(getattr(gj, name)))


def test_closest_silhouette_matches_jax(gsets):
    gj, gp = gsets
    q = np.random.default_rng(1).uniform(-2, 2, (2000, 2)).astype(np.float32)
    dj = np.asarray(Q.closest_silhouette(gj, jnp.asarray(q)))
    dp = TQ.closest_silhouette(gp, torch.as_tensor(q)).numpy()
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dp), fin)
    np.testing.assert_allclose(dp[fin], dj[fin], rtol=1e-5, atol=1e-6)


def test_ray_intersect_matches_jax(gsets):
    gj, gp = gsets
    rng = np.random.default_rng(2)
    n = 3000
    o = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    th = rng.uniform(0, 2 * math.pi, n)
    d = np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32)
    tmax = rng.uniform(0.05, 3.0, n).astype(np.float32)
    hj, tj, ij = (np.asarray(a) for a in Q.ray_intersect(
        gj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))
    hp, tp, ip = (a.numpy() for a in TQ.ray_intersect(
        gp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)))
    assert hj.any() and not hj.all()
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_allclose(tp[hj], tj[hj], rtol=1e-5, atol=1e-6)
    assert np.isinf(tp[~hj]).all()
    np.testing.assert_array_equal(ip[hj], ij[hj])


def test_sample_in_ball_matches_jax(gsets):
    gj, gp = gsets
    rng = np.random.default_rng(3)
    n = 3000
    q = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    R = rng.uniform(0.01, 1.5, n).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    pj, fj = (np.asarray(a) for a in Q.sample_in_ball(
        gj, jnp.asarray(q), jnp.asarray(R), jnp.asarray(u)))
    pp, fp = (a.numpy() for a in TQ.sample_in_ball(
        gp, torch.as_tensor(q), torch.as_tensor(R), torch.as_tensor(u)))
    assert (pj >= 0).any() and (pj < 0).any()
    np.testing.assert_array_equal(pp, pj)
    tol = _pdf_tolerance(gsets[1], q, R, pj, fj)
    bad = np.flatnonzero(~(np.abs(fp - fj) < tol))
    d = _sampled_prim_distance(gsets[1], q, pj)
    # a failure names each lane with what sets its tolerance, so that an
    # intermittent one can be read back from the log
    assert bad.size == 0, "; ".join(
        f"lane {i}: d {float(d[i])!r}, R {float(R[i])!r}, kappa "
        f"{float(1.0 / np.log(R[i] / max(d[i], 1e-4)))!r}, pdf port "
        f"{float(fp[i])!r} jax {float(fj[i])!r}, |diff| "
        f"{float(abs(fp[i] - fj[i]))!r} >= tol {float(tol[i])!r}"
        for i in bad[:20])


def _sampled_prim_distance(gp, q, pid):
    """float64 distance from each point to its sampled prim (prim 0 where
    none was sampled)."""
    verts = gp.verts.numpy().astype(np.float64)
    idx = gp.indices.numpy()
    safe = np.maximum(pid, 0)
    a, b = verts[idx[safe, 0]], verts[idx[safe, 1]]
    e = b - a
    w = q.astype(np.float64) - a
    t = np.clip((w * e).sum(-1) / np.maximum((e * e).sum(-1), 1e-30), 0, 1)
    return np.linalg.norm(w - t[:, None] * e, axis=-1)


def _pdf_tolerance(gp, q, R, pid, pdf):
    """The pdf's tolerance per lane: XLA-CPU's transcendental floor, 1e-4
    relative, plus the conditioning of G = log(R / d) / 2 pi at the
    sampled prim.  A prim that grazes the ball's rim has d ~ R, and a few
    ulps of difference in d (the two frameworks' norms round the last bit
    differently on some vector paths) move w = |e| G by
    kappa = 1 / log(R / d) times as much, relative; kappa reaches ~600 on
    3,000 lanes (a 1.2e-4 miss was seen once at rtol 1e-4).  kappa is
    computed in float64 from the same inputs; 4 ulps of float32 are
    allowed for d and R / d."""
    d = _sampled_prim_distance(gp, q, pid)
    kappa = 1.0 / np.log(R / np.maximum(d, 1e-4))
    ulp = float(np.finfo(np.float32).eps)
    return (1e-4 + 4 * ulp * np.where(pid >= 0, kappa, 0.0)) * np.abs(
        pdf) + 1e-7


def test_large_sets_take_the_traversal(monkeypatch):
    """Just above CHUNKED_DENSE_MAX prims and entities, a set with its
    trees (the BVH route) takes the traversals, and they equal brute
    force: the closest point and the silhouette distance to the dense
    sweeps (the set built without trees), the ray to the chunked sweep,
    and every in-ball sample is a prim inside its ball."""
    from elaina_tpu_torch.ops import bvh as B

    verts, idx = _open_polyline(n=TQ.CHUNKED_DENSE_MAX + 1)
    gp = TGS.make_geom_set(verts, idx, CPU, bvh=True)
    flat = TGS.make_geom_set(verts, idx, CPU)
    calls = []
    for name in ("closest_point_bvh_plain", "ray_bvh_plain",
                 "sample_in_ball_bvh_plain",
                 "closest_silhouette_bvh_plain"):
        fn = getattr(B, name)
        monkeypatch.setattr(B, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rng = np.random.default_rng(9)
    n = 500
    q = torch.as_tensor(rng.uniform(-1.6, 1.6, (n, 2)).astype(np.float32))
    th = rng.uniform(0, 2 * math.pi, n)
    d = torch.as_tensor(np.stack([np.cos(th), np.sin(th)], -1).astype(
        np.float32))
    tmax = torch.as_tensor(rng.uniform(0.05, 2.0, n).astype(np.float32))
    dist, pid = TQ.closest_point(gp, q)
    d0, p0 = TQ.closest_point(flat, q)
    np.testing.assert_allclose(dist.numpy(), d0.numpy(), rtol=1e-5,
                               atol=1e-6)
    hit, t, _ = TQ.ray_intersect(gp, q, d, tmax)
    h0, t0, _ = TQ.ray_intersect(flat, q, d, tmax)
    assert torch.equal(hit, h0) and hit.any()
    np.testing.assert_allclose(t[hit].numpy(), t0[h0].numpy(), rtol=1e-5)
    s = TQ.closest_silhouette(gp, q)
    s0 = TQ.closest_silhouette(flat, q)
    assert torch.equal(torch.isfinite(s), torch.isfinite(s0))
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-5, atol=1e-6)
    R = torch.full((n,), 0.2)
    ids, pdf = TQ.sample_in_ball(gp, q, R, torch.rand(n))
    got = ids >= 0
    assert got.any() and (pdf[got] > 0).all() and (pdf[~got] == 0).all()
    seg = torch.stack([flat.verts[flat.indices[ids[got].long(), k]]
                       for k in range(2)])
    inside, _ = TQ.prim_closest_point(2, q[got], tuple(seg))
    assert (inside < 0.2).all()
    assert sorted(set(calls)) == ["closest_point_bvh_plain",
                                  "closest_silhouette_bvh_plain",
                                  "ray_bvh_plain",
                                  "sample_in_ball_bvh_plain"]


def test_green_functions_match_jax():
    rng = np.random.default_rng(4)
    R = rng.uniform(0.01, 3.0, 5000).astype(np.float32)
    r = (R * rng.uniform(1e-3, 1.0, 5000)).astype(np.float32)
    u = rng.uniform(0, 1, (5000, 3)).astype(np.float32)
    for dim in (2, 3):
        for fj, ft, args in (
                (GJ.green_eval, GT.green_eval, (r, R)),
                (GJ.green_norm, GT.green_norm, (R,)),
                (GJ.green_pdf_radius, GT.green_pdf_radius, (r, R))):
            a = np.asarray(fj(*map(jnp.asarray, args), dim))
            b = ft(*map(torch.as_tensor, args), dim).numpy()
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        rj, pj = (np.asarray(x) for x in GJ.green_sample_radius(
            jnp.asarray(u), jnp.asarray(R), dim))
        rp, pp = (x.numpy() for x in GT.green_sample_radius(
            torch.as_tensor(u), torch.as_tensor(R), dim))
        np.testing.assert_allclose(rp, rj, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(pp, pj, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_frames_match_jax(dim):
    rng = np.random.default_rng(5)
    n = MJ.normalize(jnp.asarray(rng.normal(size=(4000, dim)), jnp.float32))
    n_np = np.asarray(n)
    v = rng.normal(size=(4000, dim)).astype(np.float32)
    fj = MJ.frame_from_normal(dim, n)
    fp = MT.frame_from_normal(dim, torch.as_tensor(n_np))
    for a, b in zip(fj, fp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    wj = np.asarray(MJ.to_world(dim, fj, jnp.asarray(v)))
    wp = MT.to_world(dim, fp, torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(wp, wj, rtol=1e-5, atol=1e-5)
    uv = rng.uniform(0, 1, (4000,) if dim == 2 else (4000, 2)).astype(
        np.float32)
    vals = tuple(rng.normal(size=(4000, 3)).astype(np.float32)
                 for _ in range(dim))
    gj = np.asarray(MJ.geometric_interpolate(
        dim, tuple(map(jnp.asarray, vals)), jnp.asarray(uv)))
    gp = MT.geometric_interpolate(dim, tuple(map(torch.as_tensor, vals)),
                                  torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(gp, gj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_direction_samplers_moments(dim):
    """Same distribution on both sides: mean and second moments of the
    sphere and hemisphere samplers, at 200k draws (standard error of a
    moment about 2e-3), agree within 0.01."""
    n = 200_000
    gen = sample_generators(0, 0, CPU)["walk"]
    key = jax.random.PRNGKey(0)
    for fj, ft in ((SJ.uniform_sample_sphere, ST.uniform_sample_sphere),
                   (SJ.uniform_sample_hemisphere,
                    ST.uniform_sample_hemisphere)):
        a = np.asarray(fj(key, (n,), dim), np.float64)
        b = ft(gen, n, dim).numpy().astype(np.float64)
        np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0,
                                   atol=1e-5)
        np.testing.assert_allclose(b.mean(0), a.mean(0), atol=0.01)
        np.testing.assert_allclose(b.T @ b / n, a.T @ a / n, atol=0.01)
    assert ST.uniform_sample_sphere_pdf(dim) == SJ.uniform_sample_sphere_pdf(
        dim)
    assert ST.uniform_sample_hemisphere_pdf(
        dim) == SJ.uniform_sample_hemisphere_pdf(dim)
    assert ST.sphere_measure(dim) == SJ.sphere_measure(dim)


def test_generators_reproducible_and_distinct():
    """One generator per (sample, stage): the same seed gives the same
    draws, and other samples, stages or seeds give other draws."""
    a = sample_generators(3, 7, CPU)
    b = sample_generators(3, 7, CPU)
    x = torch.rand(16, generator=a["walk"])
    assert torch.equal(x, torch.rand(16, generator=b["walk"]))
    others = [sample_generators(3, 8, CPU)["walk"], a["neumann"],
              sample_generators(4, 7, CPU)["walk"]]
    a2 = sample_generators(3, 7, CPU)
    x2 = torch.rand(16, generator=a2["walk"])
    for g in others:
        assert not torch.equal(x2, torch.rand(16, generator=g))
