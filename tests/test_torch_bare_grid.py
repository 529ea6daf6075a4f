"""The chain path of a candidate grid without a coordinate table in the
PyTorch port, against ``elaina_tpu``.

K12 ``candidate_band_pallas`` (``elaina_tpu/ops/pallas_queries.py``,
interpret mode) against the port's ``candidate_band_plain`` on the same
gathered rows, and against ``candidate_rows``, K12 with its gathers (each
lane's row of prim ids and the grid's segment table in, distance and prim
id out), which takes its plain PyTorch version on CPU tensors
(``chip_smoke.py`` holds the CUDA kernel to it on the card); and
``grid_closest_point`` on a bare grid (the JAX package's
``build_candidate_grid`` arrays, no ``attach_coords``) against the JAX
package's, whose CPU run takes its XLA branch
(``_grid_closest_point_xla``): rows of K <= 128 swept whole (in 2D, one
``candidate_rows`` call on the port's side), wider rows in 128-slot
chunks on coordinate planes.
Inputs are made with numpy from a seed; distances agree to 1e-5, prim ids
up to ties (``tests/test_torch_dense.py`` says why).

The JAX planar branch sweeps K // 128 chunks, so a row of K = 192 loses
its last 64 slots there (rows hold prim ids in ascending order): where a
lane's nearest prim sits past slot 128, the JAX distance is larger than
the true one.  The port sweeps every slot; the test holds it to the exact
distance over the row on those lanes and to the JAX package elsewhere.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry.grid import build_candidate_grid  # noqa: E402
from elaina_tpu.geometry.grid import \
    grid_closest_point_detail as jax_detail  # noqa: E402
from elaina_tpu.geometry.primitives import seg_closest_point  # noqa: E402
from elaina_tpu.ops.pallas_queries import candidate_band_pallas  # noqa: E402
from elaina_tpu_torch.geometry import grid as GT  # noqa: E402
from elaina_tpu_torch.geometry.primitives import \
    prim_closest_point  # noqa: E402
from elaina_tpu_torch.ops import queries as K  # noqa: E402

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


def test_candidate_band_plain_matches_pallas():
    """K12's plain version against the TPU kernel: random bands of K = 40
    with a valid mask, rows with no valid slot (inf, slot 0) and rows
    whose slots repeat one segment (equal d^2: the smallest slot)."""
    rng = np.random.default_rng(2)
    n, Kw = 600, 40
    vax = rng.uniform(-5, 5, (n, Kw)).astype(np.float32)
    vay = rng.uniform(-5, 5, (n, Kw)).astype(np.float32)
    vbx = (vax + rng.uniform(-1, 1, (n, Kw))).astype(np.float32)
    vby = (vay + rng.uniform(-1, 1, (n, Kw))).astype(np.float32)
    valid = rng.uniform(size=(n, Kw)) > 0.3
    valid[:20] = False
    for arr in (vax, vay, vbx, vby):
        arr[20:40] = arr[20:40, :1]
    q = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    args = (q, vax, vay, vbx, vby, valid)
    dj, sj = (np.asarray(x) for x in candidate_band_pallas(
        *map(jnp.asarray, args), interpret=True))
    dp, sp = (x.numpy() for x in K.candidate_band_plain(*map(_t, args)))
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dp), fin)
    np.testing.assert_allclose(dp[fin], dj[fin], rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(sp, sj)
    assert (~fin[:20]).all() and (sp[:20] == 0).all()
    first = np.argmax(valid[20:40], axis=1)
    np.testing.assert_array_equal(sp[20:40], first)


def test_candidate_band_refuses_bad_inputs():
    q = torch.zeros((4, 2))
    planes = [torch.zeros((4, 8)) for _ in range(4)]
    valid = torch.ones((4, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        K.candidate_band_plain(q, *planes, valid.int())
    with pytest.raises(ValueError):
        K.candidate_band_plain(q, *planes[:3], torch.zeros((4, 7)), valid)


def _rows_case(Kw, seed=3, n=700, P=300, R=90):
    """A segment table, candidate rows of prim ids (-1 padded) and lanes
    with their rows: rows 0-9 hold no id (inf, pid = cand[row, 0] = -1);
    rows 10-19 repeat one id in every slot; rows 20-29 hold two copies
    of one segment under two ids, the later id in the earlier slot (the
    smaller slot wins a tie)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-5, 5, (P, 2)).astype(np.float32)
    b = (a + rng.uniform(-1, 1, (P, 2))).astype(np.float32)
    seg = np.concatenate([a, b], 1).astype(np.float32)
    seg[P - 1] = seg[P - 2]                      # two ids, one segment
    cand = rng.integers(0, P - 2, (R, Kw)).astype(np.int32)
    cand[rng.uniform(size=(R, Kw)) < 0.3] = -1
    cand[:10] = -1
    cand[10:20] = cand[10:20, :1]
    cand[20:30] = -1
    cand[20:30, 1] = P - 1
    cand[20:30, Kw - 1] = P - 2
    q = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    row = rng.integers(0, R, n).astype(np.int32)
    row[:30] = np.arange(30)
    return q, row, cand, seg


@pytest.mark.parametrize("Kw", [40, 64, 30])
def test_candidate_rows_plain_matches_pallas(Kw):
    """K12 with its gathers against the TPU kernel on the rows gathered
    with numpy: distances to 1e-5, pids exact (cand[row, slot], -1 on a
    row without ids), on rows with no id, with one id repeated and with
    one segment under two ids; and against ``candidate_band_plain`` on
    the same gathered rows, bit for bit."""
    q, row, cand, seg = _rows_case(Kw)
    c = cand[row]
    g = seg[np.maximum(c, 0)]
    planes = [np.ascontiguousarray(g[..., k]) for k in range(4)]
    dj, sj = (np.asarray(x) for x in candidate_band_pallas(
        jnp.asarray(q), *map(jnp.asarray, planes), jnp.asarray(c >= 0),
        interpret=True))
    pj = np.take_along_axis(c, sj[:, None].astype(np.int64), 1)[:, 0]
    dp, pp = (x.numpy() for x in K.candidate_rows(*map(_t, (q, row, cand,
                                                            seg))))
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dp), fin)
    np.testing.assert_allclose(dp[fin], dj[fin], rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(pp, pj)
    assert (~fin[:10]).all() and (pp[:10] == -1).all()
    np.testing.assert_array_equal(pp[10:20], cand[10:20, 0])
    assert (pp[20:30] == len(seg) - 1).all()
    db, sb = K.candidate_band_plain(_t(q), *map(_t, planes), _t(c >= 0))
    assert torch.equal(_t(dp), db)
    np.testing.assert_array_equal(pp, np.take_along_axis(
        c, sb.numpy()[:, None].astype(np.int64), 1)[:, 0])


def test_candidate_rows_refuses_bad_inputs():
    q = torch.zeros((4, 2))
    row = torch.zeros((4,), dtype=torch.int32)
    cand = torch.zeros((3, 8), dtype=torch.int32)
    seg = torch.zeros((5, 4))
    with pytest.raises(TypeError):
        K.candidate_rows(q, row.long(), cand, seg)
    with pytest.raises(TypeError):
        K.candidate_rows(q, row, cand, seg.double())
    with pytest.raises(ValueError):
        K.candidate_rows(q, row, cand, torch.zeros((5, 2)))
    with pytest.raises(ValueError):
        K.candidate_rows(q[:3], row, cand, seg)
    with pytest.raises(ValueError):
        K.candidate_rows(q, row, cand[:, :0], seg)


def test_bare_grid_segment_table():
    """``grid_from_numpy`` gives a 2D grid its segment table, verts[indices]
    as (ax, ay, bx, by); ``attach_coords`` drops it with the bare path,
    and a 3D grid has none."""
    verts, idx = _loop(300)
    gj = build_candidate_grid(verts, idx, np.full(2, -4.5, np.float32),
                              np.full(2, 4.5, np.float32), K=40, max_res=8)
    gp = _port_grid(gj, verts, idx)
    want = verts[idx].reshape(-1, 4)
    assert gp.seg.dtype == torch.float32 and gp.seg.is_contiguous()
    np.testing.assert_array_equal(gp.seg.numpy(), want)
    assert GT.attach_coords(gp).seg is None
    v3, i3 = _soup(20)
    g3 = build_candidate_grid(v3, i3, np.full(3, -4.5, np.float32),
                              np.full(3, 4.5, np.float32), K=24, max_res=4)
    assert _port_grid(g3, v3, i3).seg is None


def test_bare_grid_one_call(monkeypatch):
    """A bare 2D grid of K <= 128 sweeps every lane in one
    ``candidate_rows`` call (no lane chunks), and its distances equal the
    gathered rows' ``candidate_band_plain`` bit for bit."""
    verts, idx = _loop(1500)
    gj = build_candidate_grid(verts, idx, np.full(2, -4.5, np.float32),
                              np.full(2, 4.5, np.float32), K=64, max_res=16)
    gp = _port_grid(gj, verts, idx)
    n = 70_000                                # over one chunk of 2^22 slots
    q = _t(np.random.default_rng(4).uniform(-4.8, 4.8, (n, 2))
           .astype(np.float32))
    calls = []
    rows_fn = K.candidate_rows

    def counted(*args):
        calls.append(args[0].shape[0])
        return rows_fn(*args)

    monkeypatch.setattr(K, "candidate_rows", counted)
    d, pid = GT.grid_closest_point(gp, q)
    assert calls == [n]
    row = GT.grid_row_index(gp, q)
    c = gp.cand[row.long()]
    g = gp.seg[c.clamp(min=0).long()].unbind(-1)
    db, _ = K.candidate_band_plain(q, *(x.contiguous() for x in g), c >= 0)
    tr = gp.row_trunc[row.long()]
    assert torch.equal(d[~tr], db[~tr])


def _loop(n, lobes=7):
    t = np.linspace(0, 2 * math.pi, n, endpoint=False)
    r = 3 + 0.9 * np.sin(lobes * t)
    verts = np.stack([r * np.cos(t), r * np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    return verts, idx


def _soup(n_tri, seed=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.5, 2.5, (n_tri, 3)).astype(np.float32)
    offs = rng.uniform(-0.4, 0.4, (n_tri, 3, 3)).astype(np.float32)
    return ((centers[:, None] + offs).reshape(-1, 3),
            np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3))


def _port_grid(gj, verts, idx):
    """The port's bare grid from the JAX package's arrays."""
    return GT.grid_from_numpy(
        cand=np.asarray(gj.cand), meta=[np.asarray(m) for m in gj.meta],
        row_lbound=np.asarray(gj.row_lbound),
        row_diag=np.asarray(gj.row_diag), row_trunc=np.asarray(gj.row_trunc),
        origin=np.asarray(gj.origin), inv_cell=np.asarray(gj.inv_cell),
        res=gj.res, verts=verts, indices=idx,
        colors=np.zeros((len(verts), 2, 3), np.float32), device=CPU)


# dim, K, the set, level-0 cap: K <= 128 (K12 in 2D) and wider rows (the
# planar sweep; 192 is not a multiple of the 128-slot chunk)
CASES = {"2d-K40": (2, 40, lambda: _loop(1500), 16),
         "2d-K64": (2, 64, lambda: _loop(1500), 16),
         "2d-K192": (2, 192, lambda: _loop(4000), 8),
         "2d-K256": (2, 256, lambda: _loop(4000), 8),
         "3d-K24": (3, 24, lambda: _soup(200), 6),
         "3d-K256": (3, 256, lambda: _soup(700), 4)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bare_grid_closest_point_matches_jax(name):
    dim, Kw, make, res = CASES[name]
    verts, idx = make()
    lo = np.full(dim, -4.5, np.float32)
    hi = -lo
    gj = build_candidate_grid(verts, idx, lo, hi, K=Kw, max_res=res)
    assert gj.coords is None                       # the XLA branch
    gp = _port_grid(gj, verts, idx)
    assert gp.coords is None
    rng = np.random.default_rng(Kw + dim)
    q = rng.uniform(-4.8, 4.8, (1200, dim)).astype(np.float32)
    dj, pj, pvj = jax_detail(gj, jnp.asarray(verts), jnp.asarray(idx),
                             jnp.asarray(q))
    dj, pj = np.asarray(dj), np.asarray(pj)
    dp, pp, pvp = GT.grid_closest_point_detail(gp, _t(q))
    dp, pp = dp.numpy(), pp.numpy()

    # the exact distance over each lane's row, in float64 (3D: the port's
    # triangle distance on float64 corners)
    row = GT.grid_row_index(gp, _t(q)).numpy()
    cand = np.asarray(gj.cand)[row]
    safe = np.maximum(cand, 0)
    if dim == 2:
        qq = q.astype(np.float64)[:, None]
        d_row = np.asarray(seg_closest_point(
            jnp.asarray(qq), jnp.asarray(verts[idx[safe, 0]], jnp.float32),
            jnp.asarray(verts[idx[safe, 1]], jnp.float32))[0], np.float64)
    else:
        d_row = prim_closest_point(3, _t(q)[:, None, :], tuple(
            _t(verts[idx[safe, k]]) for k in range(3)))[0].numpy()
    d_row = np.where(cand >= 0, d_row, np.inf)
    trunc = np.asarray(gj.row_trunc)[row]
    exact = np.where(trunc, np.asarray(gj.row_lbound)[row], d_row.min(1))
    np.testing.assert_allclose(dp, exact, rtol=1e-4, atol=1e-5)

    lane = np.arange(len(q))
    slot_j = np.argmax(cand == pj[:, None], axis=1)
    tail = (cand >= 0).sum(1) > 128
    skipped = tail & ~trunc & (d_row.min(1) < d_row[lane, slot_j] - 1e-6)
    if Kw > 128:
        assert tail.sum() > 100                    # rows past one chunk
    if Kw % 128 == 0 or Kw <= 128:
        assert not skipped.any()
    else:
        assert skipped.sum() > 10, skipped.sum()   # the JAX branch's gap
    same = ~skipped
    np.testing.assert_allclose(dp[same], dj[same], rtol=TOL, atol=TOL)
    assert (dp[skipped] < dj[skipped]).all()
    other = same & ~trunc & (pp != pj)
    np.testing.assert_allclose(
        d_row[lane[other], np.argmax(cand == pp[:, None], axis=1)[other]],
        d_row[lane[other], slot_j[other]], rtol=TOL, atol=TOL)
    assert other.mean() < 0.03
    ok = same & ~trunc & (pp == pj)
    for a, b in zip(pvp, pvj):
        np.testing.assert_array_equal(a.numpy()[ok], np.asarray(b)[ok])
