"""K9-2D's live mask in the PyTorch port: a lane that ``live`` leaves out
gets +inf without reading its cell's row.

``sil_band_2d(cell, q, coords, live)`` takes its plain PyTorch version on
CPU tensors (``chip_smoke.py`` phase 2c holds the CUDA kernel to it bit
for bit on the card).  Here: on the live lanes the
plain version equals ``elaina_tpu``'s ``sil_band_dma(dim=2)`` in
interpret mode, and the dead lanes get +inf, on a scattered mask, every
lane, none and the last lane alone; ``grid_closest_silhouette`` with the
mask equals the one without it on the live lanes; and a few depth steps of
a small wavy box (``_separate`` passes the walks' ``active``) give the
same contributions and walk states as the steps without the mask, bit for
bit.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu.geometry.grid import build_silhouette_grid  # noqa: E402
from elaina_tpu.ops.pallas_queries import sil_band_dma  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.geometry import geomset as TGS  # noqa: E402
from elaina_tpu_torch.geometry import grid as GT  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.ops import queries as K  # noqa: E402
from elaina_tpu_torch.solver import wost as W  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402
from elaina_tpu_torch.utils.rng import sample_generators  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5
LO = np.full(2, -1.3, np.float32)
HI = -LO


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def silgrid():
    """tests/test_torch_neumann2d.py's wavy box at 400 segments: the JAX
    SilGrid with its K9 table and the port's from the same arrays, K = 16
    on a capped grid."""
    n = 400
    verts = ((S.neumann_box(n) - 250.0) / 300.0).astype(np.float32)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    gj = make_geom_set(verts, idx)[0]
    gp = TGS.make_geom_set(verts, idx, CPU)
    ent = tuple(np.asarray(getattr(gj, f)) for f in (
        "sil_p0", "sil_p1", "sil_n1", "sil_n2", "sil_always"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        sg = build_silhouette_grid(*ent, LO, HI, K=16, max_res=20)
    arrays = {f: np.asarray(getattr(sg, f)) for f in (
        "origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
        "ent_hi")} | {"res": sg.res}
    return sg, GT.sil_grid_from_numpy(arrays, gp, CPU)


def _mask(kind: str, n: int, rng):
    if kind == "scattered":
        return rng.random(n) < 0.6
    m = np.full(n, kind == "every lane")
    if kind == "last lane":
        m[-1] = True
    return m


@pytest.mark.parametrize("kind", ["scattered", "every lane", "no lane",
                                  "last lane"])
def test_live_lanes_match_pallas(kind, silgrid):
    """The plain version with ``live`` against ``sil_band_dma(dim=2)`` on
    the live lanes in the grid; +inf on the others."""
    sg, sgp = silgrid
    rng = np.random.default_rng(17)
    n = 1536
    q = rng.uniform(-1.45, 1.45, (n, 2)).astype(np.float32)  # some outside
    lin, outside = (a.numpy() for a in QT.band_cell(sgp, _t(q)))
    cell = np.where(outside, -1, lin).astype(np.int32)
    live = _mask(kind, n, rng)
    Kw = sg.rows.shape[1]
    dj = np.asarray(sil_band_dma(jnp.asarray(cell), jnp.asarray(q),
                                 sg.coords, -(-Kw // 128), 2, interpret=True))
    dp = K.sil_band_2d(_t(cell), _t(q), sgp.coords, _t(live)).numpy()
    on = live & (cell >= 0)
    assert np.isinf(dp[~on]).all()
    found = on & (dj < 1e17)
    if kind in ("scattered", "every lane"):
        assert on.sum() > n // 3 and found.sum() > n // 6
    np.testing.assert_array_equal(dp[on] < 1e17, dj[on] < 1e17)
    np.testing.assert_allclose(dp[found], dj[found], rtol=TOL, atol=1e-9)
    # the mask changes no live lane of the unmasked sweep, bit for bit
    d0 = K.sil_band_2d(_t(cell), _t(q), sgp.coords).numpy()
    np.testing.assert_array_equal(dp[live], d0[live])


def test_closest_silhouette_with_live_mask(silgrid):
    """``grid_closest_silhouette`` with a mask: equal to the unmasked
    query on the live lanes; a dead lane in the grid reads only its
    cell's r_cap, and one outside the grid its bbox distance."""
    _, sgp = silgrid
    rng = np.random.default_rng(19)
    n = 2048
    q = _t(rng.uniform(-1.45, 1.45, (n, 2)).astype(np.float32))
    live = _t(rng.random(n) < 0.5)
    r1 = QT.grid_closest_silhouette(sgp, q, live)
    r0 = QT.grid_closest_silhouette(sgp, q)
    assert torch.equal(r1[live], r0[live])
    lin, outside = QT.band_cell(sgp, q)
    cap = sgp.r_cap[lin]
    cap = torch.where(cap >= 1e29, float("inf"), cap)
    dead = ~live & ~outside
    assert torch.equal(r1[dead], cap[dead])
    assert torch.equal(r1[~live & outside], r0[~live & outside])
    assert int((r1 != r0).sum()) > 100


def test_wavy_steps_match_without_mask(tmp_path, monkeypatch):
    """Four depth steps of the lobed curve (512 segments, its candidate
    grid) in a wavy box of 256 segments with its 2D SilGrid and prim-band
    grid, the same generators, with ``_separate``'s live mask and without
    it: contributions and next walk states equal on every lane."""
    with open(S.write_scene(str(tmp_path), 1, segments=512,
                            neumann_segments=256)) as f:
        conf = json.load(f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "GRID_MAX_RES", 32)
        mp.setattr(P, "CHUNKED_DENSE_MAX", 64)
        scene = P.Problem(2, CPU, verbose=False).load_config(
            conf["scene"]).scene
    assert scene.n_sgrid is not None
    scene.d_grid.fine = GT.build_fine_pack(scene.d_grid, S.EPS)
    n = 4096
    pts = _t(np.random.default_rng(23).uniform(0.0, 500.0, (n, 2))
             .astype(np.float32))
    calls = []
    closest = QT.grid_closest_silhouette

    def run():
        st = W.init_walk_state(pts, torch.ones(n, dtype=torch.bool))
        gens = sample_generators(3, 0, CPU)
        out = []
        for _ in range(4):
            st, c, _ = W.wost_depth_step(scene, st, gens, S.EPS)
            out.append((c, st))
        return out

    def unmasked(sg, q, live=None):
        calls.append(int((~live).sum()))
        return closest(sg, q)

    masked = run()
    monkeypatch.setattr(QT, "grid_closest_silhouette", unmasked)
    full = run()
    assert len(calls) == 4 and sum(calls) > n // 8     # walks did die
    for (c1, s1), (c0, s0) in zip(masked, full):
        assert torch.equal(c1, c0)
        for f in ("pos", "thp", "active", "on_neumann", "n_normal"):
            assert torch.equal(getattr(s1, f), getattr(s0, f)), f
