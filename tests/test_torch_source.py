"""The volumetric source of the PyTorch port against the JAX package.

The port's own NanoVDB reader against ``elaina_tpu.core.nanovdb.read_nvdb``
(exact, on files of the JAX writer and on the hand-built fixture
``tests/nvdb_fixture.py``), ``SourceGrid.sample`` against the JAX
``SourceGrid`` on the same files, one ``_source_term`` stage on identical
uniforms and directions (3D over the prim band, kernel K7's plain
version; 2D over the dense Neumann sweep), and the disk Poisson problem
-Laplace u = 1, u = (1 - r^2) / 4 (``tests/test_nanovdb.py:96-133``)
through the port's integrator.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.core import nanovdb as NJ  # noqa: E402
from elaina_tpu.core.problem import _load_source  # noqa: E402
from elaina_tpu_torch.core import nanovdb as NT  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402

CPU = torch.device("cpu")


def _write(tmp_path, case):
    rng = np.random.default_rng(0)
    path = str(tmp_path / f"{case}.nvdb")
    if case == "vec3f_none" or case == "vec3f_zip":
        NJ.write_nvdb(path, rng.uniform(0, 2, (20, 13, 9, 3)),
                      voxel_size=0.25, world_offset=(-1.0, 2.0, 0.5),
                      origin=(-5, 3, -2), name="rt",
                      codec=NJ.CODEC_ZIP if case == "vec3f_zip"
                      else NJ.CODEC_NONE)
    elif case == "float_multileaf":
        NJ.write_nvdb(path, rng.normal(size=(40, 25, 17)),
                      voxel_size=(1.0, 2.0, 3.0), origin=(100, -60, 7))
    elif case == "root_keys":
        NJ.write_nvdb(path, np.arange(360, dtype=np.float32).reshape(
            6, 5, 4, 3), origin=(-2, 4094, -4097))
    else:
        from nvdb_fixture import build_fixture

        data, _, _ = build_fixture(codec_zip=case == "handbuilt_zip")
        with open(path, "wb") as f:
            f.write(data)
    return path


@pytest.mark.parametrize("case", ["vec3f_none", "vec3f_zip",
                                  "float_multileaf", "root_keys",
                                  "handbuilt_zip", "handbuilt_raw"])
def test_read_nvdb_matches_jax(case, tmp_path):
    path = _write(tmp_path, case)
    gj, gp = NJ.read_nvdb(path), NT.read_nvdb(path)
    np.testing.assert_array_equal(gp.values, gj.values)
    for f in ("origin", "voxel_size", "world_offset", "background"):
        np.testing.assert_array_equal(getattr(gp, f), getattr(gj, f))
    assert gp.name == gj.name


def test_blosc_codec_rejected(tmp_path):
    import struct

    path = _write(tmp_path, "handbuilt_raw")
    data = bytearray(open(path, "rb").read())
    struct.pack_into("<H", data, 14, 2)
    struct.pack_into("<H", data, 16 + 168, 2)
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="BLOSC"):
        NT.read_nvdb(path)


@pytest.mark.parametrize("kind", ["npz2d", "npy2d", "nvdb2d", "nvdb3d",
                                  "npz3d"])
def test_source_grid_sample_matches_jax(kind, tmp_path):
    """Bilinear (2D) and trilinear (3D) samples, the border clamp, the
    scalar-to-RGB repeat and the 2D z = 0 bake of a .nvdb file."""
    rng = np.random.default_rng(2)
    dim = 3 if kind.endswith("3d") else 2
    path = str(tmp_path / f"s.{kind[:-2]}")
    if kind == "npz2d":
        np.savez(path, data=rng.uniform(0, 1, (32, 24, 3)).astype(np.float32),
                 origin=np.float32([-2.0, -1.5]),
                 voxel_size=np.float32([0.125, 0.25]))
    elif kind == "npy2d":
        np.save(path, rng.uniform(0, 1, (16, 12)).astype(np.float32))
    elif kind == "npz3d":
        np.savez(path, data=rng.uniform(0, 1, (9, 7, 5)).astype(np.float32),
                 origin=np.float32([-1, -1, -1]),
                 voxel_size=np.float32([0.25, 0.3, 0.5]))
    else:
        NJ.write_nvdb(path, rng.uniform(0, 1, (24, 20, 3, 3)),
                      voxel_size=0.125, world_offset=(-2.0, -1.5, -0.1))
    src_j = _load_source(path, dim)
    src_p = P.load_source(path, dim, CPU)
    lo = np.asarray(src_j.origin) - 0.3
    hi = lo + np.asarray(src_j.data.shape[:dim]) / np.asarray(
        src_j.inv_voxel) + 0.6
    pts = rng.uniform(lo, hi, (512, dim)).astype(np.float32)
    np.testing.assert_allclose(src_p.sample(torch.as_tensor(pts)).numpy(),
                               np.asarray(src_j.sample(jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-7)


def test_vdb_source_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="pyopenvdb"):
        P.load_source(str(tmp_path / "x.vdb"), 3, CPU)


def _square(half=1.0):
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    return (corners * half,
            np.array([[0, 1], [1, 2], [2, 3], [3, 0]], np.int32))


def _jax_port_pair(dim, tmp_path, monkeypatch):
    """A Neumann set with a source, as a JAX Scene and the port's: the
    closed square (2D, dense queries) or the cube surface (3D, over the
    prim-band grid, whose coordinate table the JAX side builds in interpret
    mode)."""
    from elaina_tpu.core.problem import Boundary, Scene
    from elaina_tpu.geometry.geomset import make_geom_set
    from elaina_tpu.geometry.grid import build_prim_band_grid
    from elaina_tpu_torch.utils.scenes import cube_boundary

    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(9)
    if dim == 2:
        nv, ni = _square()
    else:
        nv, ni = cube_boundary(3)
    nc = np.zeros((len(nv), 2, 3), np.float32)
    data = rng.uniform(0.5, 1.5, (12,) * dim + (3,)).astype(np.float32)
    path = str(tmp_path / "src.npz")
    np.savez(path, data=data, origin=np.full(dim, -1.0, np.float32),
             voxel_size=np.full(dim, 2.0 / 11.0, np.float32))
    bg = bgp = None
    if dim == 3:
        bg = build_prim_band_grid(nv, ni, np.full(3, -1.1, np.float32),
                                  np.full(3, 1.1, np.float32), K=32,
                                  max_res=8)
        bgp = {f: np.asarray(getattr(bg, f)) for f in (
            "origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
            "ent_hi")} | {"res": bg.res}
    scene_j = Scene(
        dirichlet=None, neumann=Boundary(gs=make_geom_set(nv, ni)[0],
                                         colors=jnp.asarray(nc)),
        d_grid=None, source=_load_source(path, dim),
        aabb_lo=jnp.full(dim, -1.0), aabb_hi=jnp.full(dim, 1.0), dim=dim,
        source_intensity=0.7, dirichlet_intensity=1.0,
        neumann_intensity=1.0, n_bgrid=bg)
    sgp = None
    if dim == 3:
        from elaina_tpu.geometry.grid import build_silhouette_grid
        gj = scene_j.neumann.gs
        sg = build_silhouette_grid(
            np.asarray(gj.sil_p0), np.asarray(gj.sil_p1),
            np.asarray(gj.sil_n1), np.asarray(gj.sil_n2),
            np.asarray(gj.sil_always), np.full(3, -1.1, np.float32),
            np.full(3, 1.1, np.float32), K=32, max_res=8)
        sgp = {f: np.asarray(getattr(sg, f)) for f in (
            "origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
            "ent_hi")} | {"res": sg.res}
    scene_p = P.scene_from_numpy(
        aabb_lo=[-1.0] * dim, aabb_hi=[1.0] * dim, device=CPU,
        neumann=(nv, ni, nc), sgrid=sgp, bgrid=bgp,
        source=P.load_source(path, dim, CPU), source_intensity=0.7)
    return scene_j, scene_p


@pytest.mark.parametrize("dim", [2, 3])
def test_source_term_matches_jax(dim, tmp_path, monkeypatch):
    """One _source_term stage on identical lanes, radii, directions and
    radius uniforms: lanes inside the box, a third of them on the Neumann
    boundary (hemisphere directions), so the radius clip fires."""
    import jax

    from elaina_tpu.solver import wost as WJ
    from elaina_tpu_torch.solver import wost as WT

    scene_j, scene_p = _jax_port_pair(dim, tmp_path, monkeypatch)
    rng = np.random.default_rng(4)
    n = 768
    eps = 0.01
    q = rng.uniform(-0.9, 0.9, (n, dim)).astype(np.float32)
    on = rng.random(n) < 0.3
    axis = rng.integers(0, dim, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    q[on, axis[on]] = sign[on]
    nrm = np.zeros((n, dim), np.float32)
    nrm[on, axis[on]] = -sign[on]                # inward normal
    R_B = rng.uniform(0.05, 1.2, n).astype(np.float32)
    live = rng.random(n) < 0.9
    thp = rng.uniform(0.5, 2.0, n).astype(np.float32)

    key = jax.random.PRNGKey(3)
    st_j = WJ.WalkState(pos=jnp.asarray(q), thp=jnp.asarray(thp),
                        active=jnp.asarray(live), on_neumann=jnp.asarray(on),
                        n_normal=jnp.asarray(nrm))
    cj = np.asarray(WJ._source_term(scene_j, st_j, jnp.asarray(live),
                                    jnp.asarray(R_B), key, eps, 32))
    # JAX's own draws of that call, handed to the port
    k_dir, k_rad = jax.random.split(key)
    dj, pj, aj = (torch.tensor(np.asarray(a)) for a in
                  WJ._sample_direction(k_dir, st_j, dim, True))
    u = torch.tensor(np.asarray(jax.random.uniform(k_rad, (n, 3))))
    monkeypatch.setattr(WT, "_sample_direction",
                        lambda gen, state, d, has_n: (dj, pj, aj))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: u)
    st_p = WT.WalkState(pos=torch.as_tensor(q), thp=torch.as_tensor(thp),
                        active=torch.as_tensor(live),
                        on_neumann=torch.as_tensor(on),
                        n_normal=torch.as_tensor(nrm))
    cp = WT._source_term(scene_p, st_p, torch.as_tensor(live),
                         torch.as_tensor(R_B), torch.Generator(), eps).numpy()
    counted = np.any(cj != 0, axis=-1)
    assert 0.3 * n < counted.sum() < live.sum()        # the clip fired
    np.testing.assert_array_equal(np.any(cp != 0, axis=-1), counted)
    np.testing.assert_allclose(cp, cj, rtol=1e-5, atol=1e-6)


def test_source_term_disk_poisson(tmp_path):
    """-Laplace u = 1 on the unit disk, u = 0 on its boundary, the source
    read from a .nvdb file: u = (1 - r^2) / 4 within 0.03 at three points
    (768 walks each, depth 64) through the port's integrator."""
    from elaina_tpu_torch.core.config import IntegratorSettings
    from elaina_tpu_torch.geometry.grid import build_candidate_grid
    from elaina_tpu_torch.solver.integrator import UniformIntegrator

    t = np.linspace(0, 2 * np.pi, 129)[:-1]
    verts = np.stack([np.cos(t), np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(128), (np.arange(128) + 1) % 128],
                   -1).astype(np.int32)
    res = 64
    path = str(tmp_path / "disk.nvdb")
    NJ.write_nvdb(path, np.ones((res, res, 1, 3), np.float32),
                  voxel_size=3.0 / res, world_offset=(-1.5, -1.5, 0.0))
    lo, hi = P.grid_bounds(verts, [-1, -1], [1, 1])
    K, _ = P.grid_size_for(len(idx))
    ga = build_candidate_grid(verts, idx, lo, hi, K=K, max_res=64)
    problem = P.Problem(2, CPU, verbose=False)
    problem.scene = P.scene_from_numpy(
        aabb_lo=[-1, -1], aabb_hi=[1, 1], device=CPU,
        dirichlet=(verts, idx, np.zeros((128, 2, 3), np.float32)),
        grid=vars(ga), source=P.load_source(path, 2, CPU))
    pts = np.array([[0.0, 0.0], [0.5, 0.0], [0.0, -0.8]], np.float32)
    reps, spp = 192, 4
    lanes = torch.as_tensor(np.repeat(pts, reps, axis=0))
    settings = IntegratorSettings(frameSize=(len(lanes), 1),
                                  samplesPerPixel=spp, maxWalkingDepth=64,
                                  epsilonShell=0.01)
    integ = UniformIntegrator(problem, settings, str(tmp_path), points=lanes)
    integ.solve()
    u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(3, reps).mean(1)
    np.testing.assert_allclose(u, (1.0 - np.sum(pts ** 2, -1)) / 4.0,
                               atol=0.03)
