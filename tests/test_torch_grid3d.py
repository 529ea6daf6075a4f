"""The port's 3D grid builds and device tables against ``elaina_tpu``.

The candidate grid, the FinePack, the prim-band grid and the silhouette
grid are host builds on the same native band passes (the port threads
them over chunks of cells), so they must give the reference's arrays
exactly; the device tables (corner planes, entity planes, color rows)
must hold the same numbers as the TPU layouts.  A later change to the
native builds shows up here on the CPU.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry import grid as GJ  # noqa: E402
from elaina_tpu.geometry.geomset import host_silhouette_entities  # noqa: E402
from elaina_tpu_torch.geometry import grid as GT  # noqa: E402
from elaina_tpu_torch.geometry.native import load_obj_native  # noqa: E402

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soup(n_tri, seed, spread=2.0, size=0.35):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tri, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n_tri, 3, 3)).astype(np.float32)
    verts = (centers[:, None] + offs).reshape(-1, 3)
    return verts, np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)


def _bumpy():
    return load_obj_native(os.path.join(REPO, "configs", "data",
                                        "bumpy3d_3.obj"), 3)


SETS = {"soup": (_soup, (160, 17), 16, 6), "bumpy": (_bumpy, (), 64, 12)}
LO = np.full(3, -3, np.float32)
HI = np.full(3, 3, np.float32)


@pytest.mark.parametrize("name", sorted(SETS))
def test_prim_band_grid_matches_jax(name):
    make, args, K, res = SETS[name]
    verts, idx = make(*args)
    gj = GJ.build_prim_band_grid(verts, idx, LO, HI, K=K, max_res=res)
    gp = GT.build_prim_band_grid(verts, idx, LO, HI, K=K, max_res=res)
    assert gp.res == gj.res
    for f in ("origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
              "ent_hi"):
        np.testing.assert_array_equal(getattr(gp, f),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert (gp.rows >= 0).sum() > gp.rows.shape[0]


@pytest.mark.parametrize("name", sorted(SETS))
def test_silhouette_grid_matches_jax(name):
    make, args, K, res = SETS[name]
    verts, idx = make(*args)
    sil = host_silhouette_entities(verts, idx)
    ent = (sil["p0"], sil["p1"], sil["n1"], sil["n2"], sil["always"])
    gj = GJ.build_silhouette_grid(*ent, LO, HI, K=K, max_res=res)
    gp = GT.build_silhouette_grid(*ent, LO, HI, K=K, max_res=res)
    assert gp.res == gj.res
    for f in ("origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
              "ent_hi"):
        np.testing.assert_array_equal(getattr(gp, f),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert (gp.rows >= 0).any()


def test_band_grids_share_the_reference_cache(tmp_path):
    """The port writes the reference's cache files (same key, same
    fields) and reads them back unchanged."""
    verts, idx = _soup(60, 4)
    sil = host_silhouette_entities(verts, idx)
    ent = (sil["p0"], sil["p1"], sil["n1"], sil["n2"], sil["always"])
    kw = dict(K=16, max_res=6)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    a = GT.build_prim_band_grid(verts, idx, LO, HI, cache_dir=str(port_dir),
                                **kw)
    s = GT.build_silhouette_grid(*ent, LO, HI, cache_dir=str(port_dir), **kw)
    GJ.build_prim_band_grid(verts, idx, LO, HI, cache_dir=str(jax_dir), **kw)
    GJ.build_silhouette_grid(*ent, LO, HI, cache_dir=str(jax_dir), **kw)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    a2 = GT.build_prim_band_grid(verts, idx, LO, HI, cache_dir=str(port_dir),
                                 **kw)
    s2 = GT.build_silhouette_grid(*ent, LO, HI, cache_dir=str(port_dir),
                                  **kw)
    for x, y in ((a, a2), (s, s2)):
        assert x.res == y.res
        for f in ("rows", "r_cap", "lbound", "origin", "inv_cell"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def _grid_numpy(g):
    return dict(cand=np.asarray(g.cand), meta=[np.asarray(m) for m in g.meta],
                row_lbound=np.asarray(g.row_lbound),
                row_diag=np.asarray(g.row_diag),
                row_trunc=np.asarray(g.row_trunc),
                origin=np.asarray(g.origin), inv_cell=np.asarray(g.inv_cell),
                res=g.res)


def test_candidate_grid_3d_matches_jax():
    """bumpy3d_3 on a 16^3 level 0: two levels and truncated deep rows."""
    verts, idx = _bumpy()
    lo, hi = np.full(3, -1.43, np.float32), np.full(3, 1.43, np.float32)
    gj = GJ.build_candidate_grid(verts, idx, lo, hi, K=256, max_res=16)
    gp = GT.build_candidate_grid(verts, idx, lo, hi, K=256, max_res=16)
    assert len(gp.meta) == len(gj.meta) == 2
    assert gp.row_trunc.any()
    for f, v in _grid_numpy(gj).items():
        if f == "meta":
            for a, b in zip(gp.meta, v):
                np.testing.assert_array_equal(a, b)
        elif f == "res":
            assert gp.res == v
        else:
            np.testing.assert_array_equal(getattr(gp, f), v, err_msg=f)


def test_fine_pack_3d_matches_jax():
    """The port's host FinePack against JAX's on a multi-level 3D grid
    (tests/test_grid.py::test_fine_pack_3d_matches_meta_chain's scene)."""
    rng = np.random.default_rng(31)
    centers = rng.uniform(-2, 2, (80, 3)).astype(np.float32)
    offs = rng.uniform(-0.3, 0.3, (80, 3, 3)).astype(np.float32)
    verts = (centers[:, None] + offs).reshape(-1, 3)
    idx = np.arange(240, dtype=np.int32).reshape(-1, 3)
    gj = GJ.build_candidate_grid(verts, idx, LO, HI, K=16, max_res=16,
                                 max_levels=4)
    assert len(gj.meta) >= 2
    gp = GT.grid_from_numpy(**_grid_numpy(gj), verts=verts, indices=idx,
                            colors=np.zeros((len(verts), 2, 3), np.float32),
                            device=CPU)
    for eps in (0.05, 0.25):
        fj = GJ.attach_fine(gj, eps).fine
        fp = GT.build_fine_pack(gp, eps)
        assert fp.res == fj.res
        assert fp.r0 == float(fj.r0)
        np.testing.assert_array_equal(fp.packed.numpy(),
                                      np.asarray(fj.packed).reshape(-1))
        np.testing.assert_array_equal(fp.inv_cell.numpy(),
                                      np.asarray(fj.inv_cell))
        q = rng.uniform(-3.2, 3.2, (2000, 3)).astype(np.float32)
        (rp, np_, lp, op), (rj, nj, lj, oj) = (
            GT.fine_decode(fp, torch.as_tensor(q)),
            GJ.fine_decode(fj, jnp.asarray(q)))
        for a, b in ((rp, rj), (np_, nj), (op, oj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the decoded bound goes through exp2: XLA's CPU version differs
        # in the last bit
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=2e-6)


def _planes(coords_jax, K, n_planes):
    """(R, n_rows, 128) TPU table -> (R, n_planes, K) planes."""
    c = np.asarray(coords_jax)
    rpp = -(-K // 128)
    flat = c.reshape(c.shape[0], -1)
    return np.stack([flat[:, p * rpp * 128:p * rpp * 128 + K]
                     for p in range(n_planes)], axis=1)


def test_device_tables_3d_match_jax():
    """Corner planes of the candidate and prim-band grids, entity planes
    of the silhouette grid and the 3D color rows hold the numbers of the
    TPU tables, in the port's layout."""
    verts, idx = _soup(90, 8)
    K = 24
    gj = GJ.build_candidate_grid(verts, idx, LO, HI, K=K, max_res=8)
    colors = np.random.default_rng(2).uniform(
        0, 1, (len(verts), 2, 3)).astype(np.float32)
    gjc = GJ.attach_shading(GJ.attach_coords(gj, verts, idx), colors, idx)
    gp = GT.attach_coords(GT.grid_from_numpy(
        **_grid_numpy(gj), verts=verts, indices=idx, colors=colors,
        device=CPU))
    Kp = GT.padded_k(K)
    assert tuple(gp.coords.shape) == (gj.cand.shape[0], 9, Kp)
    np.testing.assert_array_equal(gp.coords[:, :, :K].numpy(),
                                  _planes(gjc.coords, K, 9))
    assert (gp.coords[:, :, K:] == GT.PAD_COORD).all()
    crows = np.asarray(gjc.crows)[:2 * len(idx)]
    np.testing.assert_array_equal(
        gp.color_rows.numpy(),
        crows[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]])

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        bj = GJ.build_prim_band_grid(verts, idx, LO, HI, K=K, max_res=6)
        sil = host_silhouette_entities(verts, idx)
        sj = GJ.build_silhouette_grid(sil["p0"], sil["p1"], sil["n1"],
                                      sil["n2"], sil["always"], LO, HI, K=K,
                                      max_res=6)
    fields = ("origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
              "ent_hi")

    def arrays(g):
        return {f: np.asarray(getattr(g, f)) for f in fields} | {"res": g.res}

    from elaina_tpu_torch.geometry.geomset import make_geom_set
    bp = GT.band_grid_from_numpy(arrays(bj), verts, idx, CPU)
    sp = GT.sil_grid_from_numpy(arrays(sj), make_geom_set(verts, idx, CPU),
                                CPU)
    np.testing.assert_array_equal(bp.coords[:, :, :K].numpy(),
                                  _planes(bj.coords, K, 9))
    np.testing.assert_array_equal(sp.coords[:, :, :K].numpy(),
                                  _planes(sj.coords, K, 12))
    assert (sp.coords[:, :6, K:] == GT.PAD_COORD).all()
    assert (sp.coords[:, 6:, K:] == 0).all()


@pytest.mark.parametrize("name,dim", [("neumann3d_u", 3), ("bumpy3d_quick", 3),
                                      ("ladybug_u", 2)])
def test_evaluation_grid_points_match_jax(name, dim):
    """The slice points of a config's evaluation grid, pixel for pixel."""
    import json

    from elaina_tpu.core.evaluation_grid import EvaluationGrid as EJ
    from elaina_tpu_torch.core.evaluation_grid import EvaluationGrid as ET

    with open(os.path.join(REPO, "configs", name + ".json")) as f:
        conf = json.load(f)
    eg = conf["scene"]["evaluation_grid"]
    frame = tuple(conf["integrator"]["setting"]["frameSize"])
    pix = np.arange(frame[0] * frame[1])
    pj = np.asarray(EJ.from_json(eg, dim).points(jnp.asarray(pix), frame))
    pp = ET.from_json(eg, dim).points(torch.as_tensor(pix), frame).numpy()
    assert pp.shape == (len(pix), dim)
    np.testing.assert_array_equal(pp, pj)
