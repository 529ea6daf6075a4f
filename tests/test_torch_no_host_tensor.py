"""The PyTorch port's depth step builds no tensor from host values.

``torch.tensor`` of a Python list or numpy array on a CUDA device copies
from pageable host memory, which PyTorch completes with a stream
synchronize: the host then waits for the device's queue.  The grids (the
FinePack, the candidate grid, the band grids) and the source grid carry
their bounds as device tensors, built once with the grid, and the
per-step queries read those.  Here every way in from host values that
shows on the CPU is patched to raise (``torch.tensor``,
``torch.as_tensor``, ``torch.from_numpy``) and so is every read back to
the host (``Tensor.item``, ``.tolist``, ``.numpy`` and a tensor's
``bool``, ``int`` or ``float``) while ``fine_decode``, ``band_cell``,
``grid_cell_index``, ``grid_row_index``, ``grid_closest_silhouette``,
``band_ray_intersect``, one ``wost_depth_step``, two guided depth steps
(the training phase with its walk records, and the guiding phase) and
two ``train_on_records`` batches run, and their outputs equal the ones
taken before the patch.  A ``.to(device)`` of a host
tensor cannot show here, where every tensor is on the CPU.  Two scenes on the CPU: the lobed curve (512 segments,
with its candidate grid and FinePack) in a wavy Neumann box of 256
segments with its 2D SilGrid and prim-band grid, and the mixed-BC cube
with a unit source (its 3D band grids), the fused and the unfused step.
On the card ``chip_smoke.py`` phase 8d runs a depth step of each main
path under ``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.geometry import grid as GT  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.solver import wost as W  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402
from elaina_tpu_torch.utils.rng import sample_generators  # noqa: E402

CPU = torch.device("cpu")
N = 2048


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_host_tensor(monkeypatch):
    def refusing(name):
        def refuse(*args, **kwargs):
            raise AssertionError(f"{name} called in the depth step")
        return refuse

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refusing(f"torch.{name}"))
    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refusing(f"Tensor.{name}"))


def _load(conf: dict, dim: int, eps: float, max_res: int):
    """The scene of ``conf`` with a small grid cap, both 2D Neumann grids
    at any set size, and the FinePack baked for ``eps``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "GRID_MAX_RES", max_res)
        mp.setattr(P, "CHUNKED_DENSE_MAX", 64)
        scene = P.Problem(dim, CPU, verbose=False).load_config(conf).scene
    if scene.d_grid is not None:
        scene.d_grid.fine = GT.build_fine_pack(scene.d_grid, eps)
    return scene


@pytest.fixture(scope="module")
def wavy2d(tmp_path_factory):
    """The lobed curve of 512 segments in a wavy box of 256: a candidate
    grid with its FinePack (eps 1), a SilGrid and a prim-band grid."""
    root = str(tmp_path_factory.mktemp("wavy2d"))
    import json

    with open(S.write_scene(root, 1, segments=512,
                            neumann_segments=256)) as f:
        conf = json.load(f)
    scene = _load(conf["scene"], 2, S.EPS, 32)
    assert scene.d_grid.fine is not None
    assert scene.n_sgrid is not None and scene.n_bgrid is not None
    rng = np.random.default_rng(3)
    q = rng.uniform(-60.0, 560.0, (N, 2)).astype(np.float32)
    return scene, torch.as_tensor(q), S.EPS


@pytest.fixture(scope="module")
def cube3d(tmp_path_factory):
    """The mixed-BC cube with a unit source: 3D band grids, no candidate
    grid (36 Dirichlet triangles)."""
    root = str(tmp_path_factory.mktemp("cube3d"))
    scene = _load(S.write_mixed_cube_source(root), 3, 0.02, 8)
    assert scene.n_bgrid.coords is not None and scene.source is not None
    rng = np.random.default_rng(4)
    q = rng.uniform(-1.05, 1.05, (N, 3)).astype(np.float32)
    return scene, torch.as_tensor(q), 0.02


def _query_inputs(scene, q):
    """Ray directions, reaches and a live mask for the points q."""
    n, dim = q.shape
    rng = np.random.default_rng(5)
    d = torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    tmax = torch.as_tensor(rng.uniform(0.0, 0.5, n).astype(np.float32))
    tmax = tmax * float(scene.aabb_hi[0] - scene.aabb_lo[0])
    live = torch.as_tensor(rng.random(n) < 0.7)
    return d, tmax, live


def _grid_queries(scene, q, eps, d, tmax, live):
    """Every per-step query of the scene's grids on the points q."""
    out = {}
    g = scene.d_grid
    if g is not None:
        out["fine_decode"] = GT.fine_decode(g.fine, q)
        out["grid_cell_index"] = GT.grid_cell_index(g, q)
        out["grid_row_index"] = GT.grid_row_index(g, q)
    for name, bg in (("sil", scene.n_sgrid), ("band", scene.n_bgrid)):
        out[f"band_cell_{name}"] = QT.band_cell(bg, q)
    out["grid_closest_silhouette"] = QT.grid_closest_silhouette(
        scene.n_sgrid, q, live)
    o = q + eps * d
    out["band_ray_intersect"] = QT.band_ray_intersect(
        scene.n_bgrid, scene.neumann.gs, o, d, tmax, ref=q, live=live,
        offset=eps)
    return out


def _step(scene, q, eps, active):
    state = W.init_walk_state(q, active)
    gens = sample_generators(11, 0, CPU)
    state, _, _ = W.wost_depth_step(scene, state, gens, eps)
    st, contrib, need = W.wost_depth_step(scene, state, gens, eps)
    return {"state": (st.pos, st.thp, st.active, st.on_neumann, st.n_normal),
            "contrib": contrib, "need": need}


def _assert_same(a, b, path="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{k}]")
    else:
        assert torch.equal(a, b), path


@pytest.mark.parametrize("which", ["wavy2d", "cube3d"])
def test_grid_queries_build_no_host_tensor(which, request, monkeypatch):
    """The per-step grid queries with host values refused: the same
    outputs as before the patch."""
    scene, q, eps = request.getfixturevalue(which)
    inputs = _query_inputs(scene, q)
    want = _grid_queries(scene, q, eps, *inputs)
    _no_host_tensor(monkeypatch)
    _assert_same(_grid_queries(scene, q, eps, *inputs), want)


@pytest.mark.parametrize("which,fused", [("wavy2d", True), ("cube3d", True),
                                         ("cube3d", False)])
def test_depth_step_builds_no_host_tensor(which, fused, request,
                                          monkeypatch):
    """Two depth steps (every stage: the Dirichlet resolve on the
    FinePack or without a grid, the SilGrid radius, the source term, the
    Neumann term and the walk, fused or not in 3D), the second with host
    values refused: the same contributions, walk state and resolved count
    as before the patch."""
    scene, q, eps = request.getfixturevalue(which)
    monkeypatch.setenv("ELAINA_FUSED_BAND", "1" if fused else "0")
    assert W.fused_band_available(scene) == (fused and scene.dim == 3)
    active = torch.as_tensor(np.arange(q.shape[0]) % 5 != 0)
    want = _step(scene, q, eps, active)
    assert bool(want["state"][2].any())
    _no_host_tensor(monkeypatch)
    _assert_same(_step(scene, q, eps, active), want)


TINY_NET = {"encoding": {"base_resolution": 4, "n_levels": 3,
                         "n_features_per_level": 2, "per_level_scale": 1.5},
            "network": {"n_neurons": 16, "n_hidden_layers": 1}}


def _guide(scene):
    """The network's spec and first weights and the scene's box on the
    device, made once with the integrator (not per step)."""
    from elaina_tpu_torch.nn.network import init_trainer, make_network
    from elaina_tpu_torch.solver import guided as G

    spec = make_network(2, 33, TINY_NET)
    return spec, init_trainer(spec, CPU), G.guide_box(scene, CPU)


def _guided_steps(scene, q, eps, active, training, guide):
    """Two guided depth steps of the wavy box from fresh generators: the
    training phase fills records, the guiding phase has none."""
    from elaina_tpu_torch.solver import guided as G

    spec, trainer, box = guide
    params = trainer.ema_params
    state = W.init_walk_state(q, active)
    records = G.init_records(q.shape[0], 2, CPU) if training else None
    gens = sample_generators(11, 0, CPU)
    out = {}
    for depth in range(2):
        state, records, contrib, need = G.guided_depth_step(
            scene, spec, params, box, state, records, gens, depth, True,
            training, 0.5, 10, eps=eps)
        out[f"contrib{depth}"] = contrib
    out["state"] = (state.pos, state.thp, state.active, state.on_neumann,
                    state.n_normal)
    out["need"] = need
    if training:
        out["records"] = tuple(vars(records).values())
    return out, records


@pytest.mark.parametrize("training", [True, False])
def test_guided_depth_step_builds_no_host_tensor(training, wavy2d,
                                                 monkeypatch):
    """Two guided depth steps (the network, the mixture sample and the
    MIS pdf on every lane; in the training phase the record backfill and
    the vertex writes) with host values refused: the same outputs."""
    scene, q, eps = wavy2d
    active = torch.as_tensor(np.arange(q.shape[0]) % 5 != 0)
    guide = _guide(scene)
    want, _ = _guided_steps(scene, q, eps, active, training, guide)
    _no_host_tensor(monkeypatch)
    got, _ = _guided_steps(scene, q, eps, active, training, guide)
    _assert_same(got, want)


def test_train_on_records_builds_no_host_tensor(wavy2d, monkeypatch):
    """Two optimizer batches on the records of two training steps, with
    host values refused: the same trainer and metric (a batch that is
    dropped, for too few records or a nonfinite gradient, is dropped by
    ``torch.where``)."""
    from elaina_tpu_torch.nn.network import AdamConfig
    from elaina_tpu_torch.solver import guided as G

    scene, q, eps = wavy2d
    active = torch.ones(q.shape[0], dtype=torch.bool)
    guide = _guide(scene)
    spec, trainer, box = guide
    _, records = _guided_steps(scene, q, eps, active, True, guide)

    def train():
        tr, metric = G.train_on_records(trainer, spec,
                                        AdamConfig(), box, records,
                                        batch_size=1024, n_batches=2)
        return {"params": tr.params, "ema": tr.ema_params, "mu": tr.opt.mu,
                "nu": tr.opt.nu, "count": tr.opt.count, "metric": metric}

    want = train()
    assert int(want["count"]) == 2
    _no_host_tensor(monkeypatch)
    _assert_same(train(), want)
