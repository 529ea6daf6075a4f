"""The port's checkpoints (``elaina_tpu_torch/core/checkpoint.py``) and the
guided solve's resume, against ``elaina_tpu.core.checkpoint``.

- ``save_trainer`` / ``load_trainer`` round-trip every array bit for bit,
  the Adam step count and the extra JSON (``net_trained`` included), in
  the JAX package's key layout; ``save_solve_state`` /
  ``load_solve_state`` the sums, their squares and the sample count
  (``tests/test_aux.py``'s and ``tests/test_guided.py``'s round trips).
- A checkpoint that ``elaina_tpu.core.checkpoint.save_trainer`` writes
  loads into the port bit for bit, and the port's ``query_network`` and
  network then match the JAX package's on the loaded weights within
  ``tests/test_torch_guide_net.py``'s tolerance (the MLP's bf16 boundary
  flips: 4e-3 at most, 99% within 1e-5); a checkpoint the port writes
  loads into the JAX package the same way.
- A guided solve on the per-sample route (16 samples of which 12 train,
  a checkpoint every 8) equals bit for bit an 8-sample run resumed to 16
  from its checkpoint: the sums, their squares, the film, the trainer
  and the loss; the resumed run's 8 samples are new ones.  The JAX
  package's solve-state file (no sums of squares) resumes the same mean
  exactly; its trainer file without ``net_trained`` resumes trained.  A
  checkpoint without ``checkpoint_every`` resumes on the balanced route.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.core import checkpoint as CJ  # noqa: E402
from elaina_tpu.nn import network as NJ  # noqa: E402
from elaina_tpu.solver import distributions as DJ  # noqa: E402
from elaina_tpu.solver import guided as GJ  # noqa: E402
from elaina_tpu_torch.core import checkpoint as CT  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.nn import network as NT  # noqa: E402
from elaina_tpu_torch.solver import guided as GT  # noqa: E402
from elaina_tpu_torch.solver.distributions import n_dim_output  # noqa: E402
from tests.test_torch_budget import NET, _square  # noqa: E402

CPU = torch.device("cpu")
FIELDS = ("params", "ema_params", "mu", "nu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_trainer(seed: int = 3):
    """The port's trainer for NET after three Adam steps on seeded
    gradients: parameters, EMA and moments all differ."""
    spec = NT.make_network(2, n_dim_output(2), NET)
    tr = NT.init_trainer(spec, CPU)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        grads = {k: torch.as_tensor(rng.normal(0, 1e-2, v.shape).astype(
            np.float32)) for k, v in tr.params.items()}
        tr = NT.adam_ema_step(tr, grads, NT.AdamConfig())
    return spec, tr


def _jax_trainer(seed: int = 11):
    """The JAX package's trainer for NET with seeded EMA and moments."""
    spec = NJ.make_network(2, n_dim_output(2), NET)
    tr = NJ.init_trainer(jax.random.PRNGKey(7), spec)
    rng = np.random.default_rng(seed)

    def noisy(tree, scale, positive=False):
        out = {}
        for k, v in tree.items():
            z = rng.normal(0, scale, v.shape).astype(np.float32)
            out[k] = jnp.asarray(np.abs(z) if positive else
                                 np.asarray(v) + z)
        return out

    return spec, NJ.TrainerState(
        params=tr.params, ema_params=noisy(tr.params, 1e-3),
        opt=NJ.AdamState(mu=noisy(tr.params, 1e-3),
                         nu=noisy(tr.params, 1e-6, positive=True),
                         count=jnp.asarray(5, jnp.int32)))


def _same_trainer(a: dict, b: dict) -> None:
    assert a["count"] == b["count"]
    for f in FIELDS:
        assert set(a[f]) == set(b[f])
        for k in a[f]:
            assert a[f][k].dtype == b[f][k].dtype == np.float32
            np.testing.assert_array_equal(a[f][k], b[f][k], err_msg=(f, k))


def _jax_numpy(tr) -> dict:
    return {"params": {k: np.asarray(v) for k, v in tr.params.items()},
            "ema_params": {k: np.asarray(v)
                           for k, v in tr.ema_params.items()},
            "mu": {k: np.asarray(v) for k, v in tr.opt.mu.items()},
            "nu": {k: np.asarray(v) for k, v in tr.opt.nu.items()},
            "count": int(tr.opt.count)}


@pytest.mark.parametrize("extra", [None, {"spp": 17, "net_trained": False},
                                   {"spp": 4, "net_trained": True}])
def test_trainer_round_trip(tmp_path, extra):
    _, tr = _port_trainer()
    path = str(tmp_path / "ck.npz")
    CT.save_trainer(path, tr, extra)
    back, meta = CT.load_trainer(path)
    _same_trainer(NT.trainer_to_numpy(back), NT.trainer_to_numpy(tr))
    assert meta == (extra or {})
    with np.load(path) as z:
        names = set(tr.params)
        assert {k for k in z.files if "/" in k} == {
            f"{g}/{k}" for g in ("params", "ema", "mu", "nu") for k in names}
        assert z["opt_count"].dtype == np.int32
        assert ("extra_json" in z.files) == bool(extra)


@pytest.mark.parametrize("with_sq", [False, True])
def test_solve_state_round_trip(tmp_path, with_sq):
    rng = np.random.default_rng(2)
    sums = torch.as_tensor(rng.uniform(0, 9, (16, 3)).astype(np.float32))
    sq = sums * sums if with_sq else None
    path = str(tmp_path / "s.npz")
    CT.save_solve_state(path, sums, 9, {"k": 1}, solution_sq_sum=sq)
    got, spp, extra, got_sq = CT.load_solve_state(path)
    np.testing.assert_array_equal(got, sums.numpy())
    assert spp == 9 and extra == {"k": 1}
    assert (got_sq is None) != with_sq
    if with_sq:
        np.testing.assert_array_equal(got_sq, sq.numpy())
    # the JAX package reads the port's file
    sol_j, spp_j, extra_j = CJ.load_solve_state(path)
    np.testing.assert_array_equal(np.asarray(sol_j), sums.numpy())
    assert spp_j == 9 and extra_j == {"k": 1}


def _raw_close(got: np.ndarray, want: np.ndarray) -> None:
    """tests/test_torch_guide_net.py's tolerance on network outputs."""
    diff = np.abs(got - want)
    assert diff.max() <= 4e-3
    assert np.mean(diff <= 1e-5) >= 0.99


def _guided_integrator(spp=16, train=12, **kw):
    settings = IntegratorSettings(
        frameSize=(16, 16), samplesPerPixel=spp, maxWalkingDepth=32,
        epsilonShell=1.0, trainSppCount=train,
        uniformFractionInTrainingPhase=0.5,
        uniformFractionInGuidingPhase=0.5,
        maxGuidedDepthInTrainingPhase=6, maxGuidedDepthInGuidingPhase=6,
        **kw)
    integ = GT.GuidedIntegrator(_square(), settings, "unused")
    integ.reset_network(NET)
    return integ


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    spec_j, tr_j = _jax_trainer()
    path = str(tmp_path / "jax.npz")
    CJ.save_trainer(path, tr_j, {"spp": 5, "net_trained": False})
    tr, meta = CT.load_trainer(path)
    assert meta == {"spp": 5, "net_trained": False}
    _same_trainer(NT.trainer_to_numpy(tr), _jax_numpy(tr_j))
    # the port's query at a JAX point, on the loaded EMA weights
    integ = _guided_integrator()
    integ.trainer = tr
    p = np.array([260.0, 190.0], np.float32)
    box = integ.problem.scene
    x = GJ.normalize_coord(jnp.asarray(p)[None], jnp.asarray(box.aabb_lo),
                           jnp.asarray(box.aabb_hi))
    raw_j = NJ.apply_network(spec_j, tr_j.ema_params, x)
    vmm_j = DJ.vmm_from_raw(raw_j, 2)
    vmm = integ.query_network(p)
    for f in ("lam", "kappa", "mu", "weight"):
        np.testing.assert_allclose(getattr(vmm, f).numpy(),
                                   np.asarray(getattr(vmm_j, f)),
                                   rtol=4e-3, atol=4e-3, err_msg=f)
    # the network on many points
    xs = np.random.default_rng(5).uniform(0, 1, (4096, 2)).astype(
        np.float32)
    want = np.asarray(NJ.apply_network(spec_j, tr_j.ema_params,
                                       jnp.asarray(xs)))
    got = NT.apply_network(integ.spec, tr.ema_params, torch.as_tensor(xs))
    _raw_close(got.numpy(), want)


def test_port_checkpoint_loads_into_jax(tmp_path):
    spec, tr = _port_trainer()
    path = str(tmp_path / "port.npz")
    CT.save_trainer(path, tr, {"spp": 3, "net_trained": True})
    tr_j, meta = CJ.load_trainer(path)
    assert meta == {"spp": 3, "net_trained": True}
    _same_trainer(_jax_numpy(tr_j), NT.trainer_to_numpy(tr))
    spec_j = NJ.make_network(2, n_dim_output(2), NET)
    xs = np.random.default_rng(6).uniform(0, 1, (4096, 2)).astype(
        np.float32)
    want = np.asarray(NJ.apply_network(spec_j, tr_j.ema_params,
                                       jnp.asarray(xs)))
    got = NT.apply_network(spec, tr.ema_params, torch.as_tensor(xs))
    _raw_close(got.numpy(), want)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A 16-sample run with a checkpoint every 8, an 8-sample run, and
    that run resumed to 16 from its checkpoint."""
    root = tmp_path_factory.mktemp("ck")
    whole = _guided_integrator()
    whole.solve(checkpoint_path=str(root / "whole.npz"), checkpoint_every=8)
    first = _guided_integrator(spp=8)
    ck = str(root / "half.npz")
    first.solve(checkpoint_path=ck, checkpoint_every=8)
    rest = _guided_integrator()
    rest.solve(checkpoint_path=ck, checkpoint_every=8)
    return root, whole, first, rest


def test_resume_equals_the_unbroken_run(resumed):
    root, whole, first, rest = resumed
    assert getattr(whole, "balance_rounds", None) is None   # per-sample
    assert whole.spp == rest.spp == 16 and first.spp == 8
    assert whole.spp_done == 16 and rest.spp_done == 8
    for f in ("sum", "sum_sq"):
        np.testing.assert_array_equal(getattr(rest, f).numpy(),
                                      getattr(whole, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(rest.films["SOLUTION"].pixels(),
                                  whole.films["SOLUTION"].pixels())
    _same_trainer(NT.trainer_to_numpy(rest.trainer),
                  NT.trainer_to_numpy(whole.trainer))
    assert first.loss_history + rest.loss_history == whole.loss_history
    assert len(whole.loss_history) == 12 and rest._net_trained
    np.testing.assert_array_equal(rest.standard_error(),
                                  whole.standard_error())
    # the resumed samples are new ones, not the first 8 again
    later = rest.sum.numpy() - first.sum.numpy()
    assert not np.allclose(later, first.sum.numpy(), rtol=1e-3)
    # the checkpoint of the unbroken run at 16 holds its state
    sums, spp, extra, sq = CT.load_solve_state(str(root / "whole.npz")
                                               + ".solve.npz")
    np.testing.assert_array_equal(sums, whole.sum.numpy())
    np.testing.assert_array_equal(sq, whole.sum_sq.numpy())
    tr, meta = CT.load_trainer(str(root / "whole.npz"))
    assert spp == 16 and meta == {"spp": 16, "net_trained": True}
    _same_trainer(NT.trainer_to_numpy(tr), NT.trainer_to_numpy(whole.trainer))


def test_resume_from_jax_files(resumed):
    """The JAX package's files: a solve state without sums of squares
    resumes the same mean (the standard error's variance then comes from
    the resumed samples); a trainer without ``net_trained`` resumes as
    trained."""
    root, whole, first, rest = resumed
    ck = str(root / "jax.npz")
    host = NT.trainer_to_numpy(first.trainer)

    def jx(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    CJ.save_trainer(ck, NJ.TrainerState(
        params=jx(host["params"]), ema_params=jx(host["ema_params"]),
        opt=NJ.AdamState(mu=jx(host["mu"]), nu=jx(host["nu"]),
                         count=jnp.asarray(host["count"], jnp.int32))))
    CJ.save_solve_state(ck + ".solve.npz", jnp.asarray(first.sum.numpy()),
                        8)
    with np.load(ck) as z:
        assert "extra_json" not in z.files
    again = _guided_integrator()
    again.solve(checkpoint_path=ck, checkpoint_every=8)
    assert again._net_trained and again.spp_done == 8
    np.testing.assert_array_equal(again.sum.numpy(), rest.sum.numpy())
    np.testing.assert_array_equal(again.films["SOLUTION"].pixels(),
                                  rest.films["SOLUTION"].pixels())
    later_sq = rest.sum_sq.numpy() - first.sum_sq.numpy()
    np.testing.assert_allclose(again.sum_sq.numpy(), later_sq * 2.0,
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(again.standard_error()).all()


def test_resume_on_the_balanced_route(resumed):
    """A checkpoint given without ``checkpoint_every`` resumes on the
    balanced route, from its 8 samples to 16, and is not written."""
    root, _, first, _ = resumed
    ck = str(root / "balanced.npz")
    CT.save_trainer(ck, first.trainer, {"spp": 8, "net_trained": True})
    CT.save_solve_state(ck + ".solve.npz", first.sum, 8,
                        solution_sq_sum=first.sum_sq)
    integ = _guided_integrator()
    integ.solve(checkpoint_path=ck)
    assert integ.balance_rounds["train"] and integ.balance_rounds["guide"]
    assert integ.spp == 16 and integ.spp_done == 8
    assert integ.train_spp_achieved == pytest.approx(12)
    assert np.isfinite(integ.films["SOLUTION"].pixels()).all()
    assert CT.load_solve_state(ck + ".solve.npz")[1] == 8
