"""The port's multi-rank path (``elaina_tpu_torch/parallel/dp.py``, the
lane-sharded balanced solve, ``parallel/dryrun.py`` and ``--devices``)
against ``elaina_tpu.parallel.dp`` and ``tests/test_parallel_solve.py``,
on two gloo ranks on the CPU.

The ranks run in spawned processes (``tests/torch_ranks.py``, which does
not import JAX), once for the module: every item of ``torch_ranks.ITEMS``
in turn, within ``torch_ranks.JOIN_S`` seconds (a hang fails every test
here).  JAX runs in this process on ``make_mesh(2)`` of conftest's eight
virtual devices.

- ``sharded_train_on_records`` and ``train_on_records(group=)`` on the
  same numpy records, split into two lane halves, and the same initial
  weights, against JAX's ``dp.sharded_train_on_records`` and
  ``train_on_records(axis_name=)`` under ``shard_map``: the tolerances of
  ``tests/test_torch_guided.py::test_train_on_records_matches_jax``, and
  each form's trainers bit-equal on the two ranks.
- ``tests/test_parallel_solve.py`` in the port: the sharded uniform square
  within MC of the single-rank solve (JAX's 8% of the mean) and within
  0.07 of u; identical worklists on both ranks give different ``lsteps``;
  the guided square with both phases sharded, its trainers bit-equal on
  both ranks, trained, within MC of the single-rank solve.
- A lockstep training chunk in which rank 1 has no sample ends, with the
  same iterations and trainers on both ranks.
- ``oversub_lanes`` and the tail width against the JAX package's over a
  grid of (n, spp, lane multiple), in this process.
- A budgeted 2-rank solve: the same rounds on both ranks.
- The dry run's five steps, and its default device (the card).
- ``python -m elaina_tpu_torch run conf.json --devices 2 --device cpu``
  writes one ``result.json`` whose ``walk_steps`` is the sum of its
  ``walk_steps_by_rank``; ``--devices 2`` on the card with fewer cards
  raises before any spawn.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from elaina_tpu.nn import network as NJ  # noqa: E402
from elaina_tpu.parallel import dp as DJ  # noqa: E402
from elaina_tpu.solver import guided as GJ  # noqa: E402
from elaina_tpu.solver import wost as WJ  # noqa: E402
from elaina_tpu_torch.solver import balanced as B  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402
from tests.test_torch_guide_net import _records  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _BoxScene:
    """What the JAX training functions read of a scene."""

    dim = 2
    aabb_lo = jnp.asarray([-1.0, -1.0])
    aabb_hi = jnp.asarray([1.0, 1.0])


@pytest.fixture(scope="module")
def inputs():
    """The records and initial weights both sides train on."""
    spec_j = NJ.make_network(2, 33, TR.SMALL)
    tr_j = NJ.init_trainer(jax.random.PRNGKey(42), spec_j)
    return _records(5), {k: np.asarray(v) for k, v in tr_j.params.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    """Every rank item's output, by item and rank, and JAX's trainers
    (``"jax"``), computed here while the ranks run."""
    d = str(tmp_path_factory.mktemp("ranks"))
    rec, p0 = inputs
    np.savez(os.path.join(d, "train_inputs.npz"), **rec,
             **{f"p_{k}": v for k, v in p0.items()})
    deadline = time.time() + TR.JOIN_S
    ctx = TR.start_ranks(d)
    try:
        out = {"jax": _jax_trained(rec)}
    finally:
        TR.wait_ranks(ctx, deadline)
    for name in TR.ITEMS:
        out[name] = []
        for r in range(TR.N_RANKS):
            with np.load(os.path.join(d, f"{name}_{r}.npz")) as z:
                out[name].append({k: z[k] for k in z.files})
    return out


def _trainer(res: dict, prefix: str) -> dict:
    t = {"count": int(res[f"{prefix}count"])}
    for field in ("params", "ema_params", "mu", "nu"):
        t[field] = {k.split(".", 2)[2]: v for k, v in res.items()
                    if k.startswith(f"{prefix}{field}.")}
    return t


def _bit_equal(a: dict, b: dict, prefix: str) -> None:
    keys = [k for k in a if k.startswith(prefix)]
    assert keys and keys == [k for k in b if k.startswith(prefix)]
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _against_jax(got: dict, metric: float, tr_j, m_j, p0: dict) -> None:
    """tests/test_torch_guided.py::test_train_on_records_matches_jax's
    tolerances."""
    assert got["count"] == int(tr_j.opt.count) == 2
    assert metric == pytest.approx(float(m_j), rel=1e-4)
    for k in p0:
        assert np.abs(np.asarray(tr_j.params[k]) - p0[k]).max() > 1e-3, k
        for field, tree, tol in (("params", tr_j.params, 2e-4),
                                 ("ema_params", tr_j.ema_params, 2e-5)):
            diff = np.abs(got[field][k] - np.asarray(tree[k]))
            assert np.mean(diff <= tol) >= 0.99, (field, k)
        for field, tree in (("mu", tr_j.opt.mu), ("nu", tr_j.opt.nu)):
            want = np.asarray(tree[k])
            gap = np.abs(got[field][k] - want).max() / np.abs(want).max()
            assert gap <= 0.07, (field, k, gap)


def _jax_records(rec):
    return GJ.WalkRecords(**{k: jnp.asarray(v) for k, v in rec.items()})


def _rec_spec(records):
    return jax.tree.map(lambda _: PS(None, DJ.AXIS), records)._replace(
        cur=PS(DJ.AXIS))


def _jax_trained(rec) -> dict:
    """JAX's two training forms on ``make_mesh(2)``: ``dp.
    sharded_train_on_records`` and ``train_on_records(axis_name=)`` under
    ``shard_map``, each (trainer', metric)."""
    spec_j = NJ.make_network(2, 33, TR.SMALL)
    tr_j = NJ.init_trainer(jax.random.PRNGKey(42), spec_j)
    records = _jax_records(rec)
    mesh = DJ.make_mesh(2)
    sharded = DJ.sharded_train_on_records(
        mesh, tr_j, spec_j, NJ.AdamConfig(), _BoxScene(), records,
        batch_size=4096, n_batches=2)
    fn = jax.shard_map(
        lambda tr, r: GJ.train_on_records(
            tr, spec_j, NJ.AdamConfig(), _BoxScene(), r, batch_size=4096,
            n_batches=2, axis_name=DJ.AXIS),
        mesh=mesh, in_specs=(PS(), _rec_spec(records)),
        out_specs=(PS(), PS()), check_vma=False)
    return {"sharded": sharded, "group": fn(tr_j, records)}


@pytest.mark.parametrize("form", ["sharded", "group"])
def test_training_forms_match_jax(ranks, inputs, form):
    """``sharded``: ``dp.sharded_train_on_records``; ``group``:
    ``train_on_records(group=)``."""
    _, p0 = inputs
    tr_j2, m_j = ranks["jax"][form]
    r0, r1 = ranks["train"]
    _bit_equal(r0, r1, f"{form}.")
    assert r0[f"{form}_metric"] == r1[f"{form}_metric"]
    _against_jax(_trainer(r0, f"{form}."), float(r0[f"{form}_metric"]),
                 tr_j2, m_j, p0)


def test_sharded_uniform_square(ranks):
    """test_parallel_solve.py::test_sharded_uniform_solve_matches_analytic:
    the same estimator on other streams."""
    single = TR.uniform_square()
    single.solve()
    ref = (single.sum / single.spp).numpy()
    r0, r1 = ranks["square"]
    np.testing.assert_array_equal(r0["mean"], r1["mean"])
    img = r0["mean"]
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 0.08 * max(abs(ref.mean()), 1e-3)
    np.testing.assert_allclose(img[:, 0], (TR.PTS[:, 0] + 1) / 2, atol=0.07)
    # each rank walked its half; the counts add up on both
    assert int(r0["steps"]) == int(r1["steps"]) == int(r0["rank_steps"]) \
        + int(r1["rank_steps"])
    assert int(r0["rank_steps"]) > 0 and int(r1["rank_steps"]) > 0


def test_sharded_chunk_rng_decorrelated(ranks):
    """test_parallel_solve.py::test_sharded_chunk_rng_decorrelated: the same
    worklist on both ranks, so unequal per-lane steps come from the
    streams alone."""
    r0, r1 = ranks["rng"]
    assert int(r0["steps"]) > 0 and int(r1["steps"]) > 0
    assert not np.array_equal(r0["lsteps"], r1["lsteps"])


def test_sharded_guided_both_phases(ranks):
    """test_parallel_solve.py::test_sharded_guided_guiding_phase: both
    phases sharded, the training phase in lockstep; the trainers equal bit
    for bit on both ranks."""
    r0, r1 = ranks["guided"]
    _bit_equal(r0, r1, "trainer.")
    np.testing.assert_array_equal(r0["mean"], r1["mean"])
    single = TR.guided_square()
    single.solve()
    ref = (single.sum / single.spp).numpy()
    img = r0["mean"]
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 0.12 * max(abs(ref.mean()), 1e-3)
    assert int(r0["train_steps"]) > 0 and bool(r0["trained"])
    assert int(r0["trainer.count"]) > 0 and np.isfinite(r0["loss"]).all()
    for k, v in r0.items():
        if k.startswith("trainer."):
            assert np.isfinite(v).all(), k


def test_lockstep_with_an_empty_rank(ranks):
    r0, r1 = ranks["empty_rank"]
    assert int(r0["ran"]) == int(r1["ran"]) and int(r0["checks"]) == int(
        r1["checks"])
    assert int(r0["done"]) == 3 * len(TR.PTS) and int(r0["steps"]) > 0
    assert int(r1["done"]) == 0 and int(r1["steps"]) == 0
    # rank 1 ran every optimizer pass with no record of its own
    _bit_equal(r0, r1, "trainer.")
    assert int(r0["trainer.count"]) > 0


@pytest.mark.parametrize("n, spp, multiple", [
    pytest.param(n, spp, k, id=f"{n}-{spp}-{k}")
    for n in (1, 6, 1000, 3000)
    for spp in (1, 32)
    for k in (1, 2, 3, 8)])
def test_oversub_and_tail_lanes_match_jax(n, spp, multiple):
    target = int(os.environ.get("ELAINA_LANE_TARGET", 64 * 1024))
    m = B.oversub_lanes(n, spp, target, multiple)
    assert m == WJ.oversub_lanes(n, spp, multiple)
    # elaina_tpu/solver/wost.py:1252-1255, the tail width under a mesh
    assert B.tail_lanes(m, multiple) == (m // 4) // multiple * multiple


def test_budgeted_rounds_equal_on_both_ranks(ranks):
    r0, r1 = ranks["budget"]
    rounds = [json.loads(str(r["rounds"])) for r in (r0, r1)]
    assert rounds[0] and len(rounds[0]) == len(rounds[1])
    for a, b in zip(*rounds):
        a.pop("rank_steps"), b.pop("rank_steps")
        assert a == b
    np.testing.assert_array_equal(r0["done"], r1["done"])
    np.testing.assert_array_equal(r0["mean"], r1["mean"])
    assert (r0["done"] >= 1).all() and np.isfinite(r0["mean"]).all()


def test_dryrun_on_two_ranks(ranks):
    s0, s1 = (json.loads(str(r["summary"])) for r in ranks["dryrun"])
    assert s0 == s1 and s0["ranks"] == 2 and s0["backend"] == "gloo"
    assert s0["uniform_steps"] > 0 and s0["guided_train_steps"] > 0
    assert np.isfinite(s0["train_metric"])


def test_dryrun_defaults_to_the_card():
    """``dryrun()`` runs on the card unless the caller asks for the CPU,
    as its CLI does."""
    import inspect

    from elaina_tpu_torch.parallel import dryrun

    assert inspect.signature(dryrun.dryrun).parameters["device"].default \
        == "cuda"


def _small_conf(root: str) -> str:
    from elaina_tpu_torch.utils import scenes as S

    conf = S.write_scene(root, 2, segments=256, frame=16)
    with open(conf) as f:
        c = json.load(f)
    c["base_path"] = root + "/"
    c["integrator"]["setting"]["maxWalkingDepth"] = 16
    with open(conf, "w") as f:
        json.dump(c, f)
    return conf


def test_cli_devices_two_on_the_cpu(tmp_path):
    conf = _small_conf(str(tmp_path))
    env = dict(os.environ, ELAINA_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "elaina_tpu_torch", "run", conf, "--devices",
         "2", "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=TR.JOIN_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(conf) as f:
        c = json.load(f)
    out = tmp_path / c["exp_name"]
    results = list(tmp_path.rglob("result.json"))
    assert results == [out / "result.json"]
    res = json.loads((out / "result.json").read_text())
    assert res["devices"] == 2 and len(res["walk_steps_by_rank"]) == 2
    assert res["walk_steps"] == sum(res["walk_steps_by_rank"])
    assert min(res["walk_steps_by_rank"]) > 0
    assert (out / "solution.exr").exists()


def test_devices_need_a_card_each(tmp_path, monkeypatch):
    from elaina_tpu_torch import __main__ as M
    from elaina_tpu_torch.exec import run_expr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    conf = str(tmp_path / "missing.json")
    with pytest.raises(RuntimeError, match="one card a rank"):
        M.main(["run", conf, "--devices", "2"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="NCCL takes one card a rank"):
        run_expr(conf, devices=2)
    monkeypatch.setenv("ELAINA_DEVICES", "two")
    with pytest.raises(ValueError, match="ELAINA_DEVICES"):
        run_expr(conf)
