"""The PyTorch port's guiding network (``elaina_tpu_torch/nn/``) against
``elaina_tpu.nn``.

- The 2D encoding (direct bilinear reads) against the JAX package's
  tent-matmul form ``_grid_encode_2d_separable`` at ladybug_n's encoding
  (8 levels x 4 features, base 8, scale 1.405: a 15,383 x 4 table, at full
  width), values to 1e-5 and table gradients to 1e-4 relative; a hashed
  spec against ``_grid_encode_gather``.
- ``apply_network`` with the JAX package's initial weights carried over
  (``trainer_from_numpy``).  Each layer rounds its input to bf16 after a
  float32 sum whose order differs between XLA-CPU and PyTorch's BLAS, so
  a hidden value that lies at a bf16 rounding boundary can round one bf16
  ulp (2^-8 relative) apart on the two sides, and the outputs then differ
  by about |w| |h| 2^-8: at most 4e-3 here, while 99% of the outputs
  agree to 1e-5.
- ``_train_loss``'s gradients against ``jax.grad`` (the backward's bf16
  rounding of the cotangents read from its jaxpr), to 1e-3 relative of
  each leaf's largest gradient (the same bf16 boundary flips).
- Three ``adam_ema_step``s on identical gradients, one clipped and one
  nonfinite (dropped), compared through ``trainer_to_numpy`` to 1e-5
  relative.
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
from elaina_tpu_torch.nn import encoding as ET  # noqa: E402
from elaina_tpu_torch.nn import network as NT  # noqa: E402
from elaina_tpu_torch.solver import guided as GT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"encoding": {"base_resolution": 4, "n_levels": 4,
                      "n_features_per_level": 2, "per_level_scale": 1.5},
         "network": {"n_neurons": 32, "n_hidden_layers": 2}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ladybug_net() -> dict:
    with open(os.path.join(REPO, "configs", "ladybug_n.json")) as f:
        return json.load(f)["network"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_params(spec, seed: int, table_scale: float | None = None) -> dict:
    """The JAX package's initial parameters as numpy; ``table_scale``
    redraws the table wider than its +-1e-4 init, so that it matters."""
    tr = NJ.init_trainer(jax.random.PRNGKey(seed), spec)
    p = {k: np.asarray(v) for k, v in tr.params.items()}
    if table_scale is not None:
        p["table"] = np.random.default_rng(seed).uniform(
            -table_scale, table_scale, p["table"].shape).astype(np.float32)
    return p


def test_specs_match_jax():
    """make_grid_encoding and make_network field for field: DenseGrid 2D
    (ladybug_n), a HashGrid with hashed levels, the 3D tri-plane spec."""
    cases = [(2, _ladybug_net()),
             (2, {"encoding": {"otype": "HashGrid", "n_levels": 6,
                               "base_resolution": 16,
                               "per_level_scale": 2.0,
                               "log2_hashmap_size": 12}}),
             (3, _ladybug_net())]
    for dim, conf in cases:
        sj = NJ.make_network(dim, 33, conf)
        st = NT.make_network(dim, 33, conf)
        assert tuple(sj.encoding) == tuple(st.encoding)
        assert (sj.n_neurons, sj.n_hidden, sj.n_out) == (
            st.n_neurons, st.n_hidden, st.n_out)
    assert NT.make_network(2, 33, _ladybug_net()).encoding.n_params == 15383
    assert any(NT.make_network(2, 33, cases[1][1]).encoding.hashed)


def test_encoding_matches_separable_at_ladybug_n():
    spec = ET.make_grid_encoding(2, _ladybug_net()["encoding"])
    assert spec.n_params == 15383 and spec.out_dim == 32
    table = np.random.default_rng(0).uniform(
        -1, 1, (spec.n_params, spec.n_features)).astype(np.float32)
    x = np.random.default_rng(1).uniform(-0.05, 1.05, (4096, 2)).astype(
        np.float32)
    x[:4] = [[0, 0], [1, 1], [0, 1], [0.5, 1.0]]
    want = np.asarray(EJ._grid_encode_2d_separable(spec, jnp.asarray(table),
                                                   jnp.asarray(x)))
    tt = _t(table).requires_grad_(True)
    got = ET.grid_encode(spec, tt, _t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    w = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    gj = np.asarray(jax.grad(lambda t: jnp.sum(
        EJ._grid_encode_2d_separable(spec, t, jnp.asarray(x)) * w))(
            jnp.asarray(table)))
    (gt,) = torch.autograd.grad((got * _t(w)).sum(), tt)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                               atol=1e-4 * np.abs(gj).max())


def test_hashed_encoding_matches_gather():
    spec = ET.make_grid_encoding(2, {"otype": "HashGrid", "n_levels": 6,
                                     "n_features_per_level": 2,
                                     "base_resolution": 16,
                                     "per_level_scale": 2.0,
                                     "log2_hashmap_size": 12})
    table = np.random.default_rng(3).uniform(
        -1, 1, (spec.n_params, spec.n_features)).astype(np.float32)
    x = np.random.default_rng(4).uniform(0, 1, (2048, 2)).astype(np.float32)
    want = np.asarray(EJ._grid_encode_gather(spec, jnp.asarray(table),
                                             jnp.asarray(x)))
    got = ET.grid_encode(spec, _t(table), _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_apply_network_matches_jax_with_carried_weights():
    spec_j = NJ.make_network(2, 33, _ladybug_net())
    spec_t = NT.make_network(2, 33, _ladybug_net())
    params = _jax_params(spec_j, 0, table_scale=1.0)
    x = np.random.default_rng(5).uniform(0, 1, (4096, 2)).astype(np.float32)
    want = np.asarray(NJ.apply_network(
        spec_j, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x)))
    tr = NT.trainer_from_numpy(params)
    net = NT.GuidingNetwork(spec_t, tr.params)
    assert {k for k, _ in net.named_parameters()} == set(params)
    got = net(_t(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (4096, 33)
    diff = np.abs(got - want)
    assert diff.max() <= 4e-3
    assert np.mean(diff <= 1e-5) >= 0.99
    np.testing.assert_array_equal(
        got, NT.apply_network(spec_t, tr.params, _t(x)).numpy())


def _records(seed: int, R: int = 4, N: int = 2048) -> dict:
    """Seeded walk records in and around the box [-1, 1]^2, with the slot
    counts 0..4."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, (R, N))
    nth = rng.uniform(-np.pi, np.pi, (R, N))
    return dict(
        pos=rng.uniform(-1.05, 1.05, (R, N, 2)).astype(np.float32),
        dir=np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32),
        dir_pdf=rng.uniform(0.05, 1.0, (R, N)).astype(np.float32),
        thp=rng.uniform(0.5, 2.0, (R, N)).astype(np.float32),
        sol=rng.uniform(0.0, 1.0, (R, N, 3)).astype(np.float32),
        on_neumann=rng.random((R, N)) < 0.3,
        normal=np.stack([np.cos(nth), np.sin(nth)], -1).astype(np.float32),
        cur=rng.integers(0, 5, N).astype(np.int32))


def test_train_loss_gradients_match_jax():
    spec_j = NJ.make_network(2, 33, SMALL)
    spec_t = NT.make_network(2, 33, SMALL)
    params = _jax_params(spec_j, 42, table_scale=0.5)
    rec = _records(6, R=1)
    n = rec["cur"].shape[0]
    args = (rec["pos"][0] * 0.5 + 0.5, rec["dir"][0], rec["sol"][0, :, 0],
            rec["dir_pdf"][0], rec["on_neumann"][0], rec["normal"][0],
            np.arange(n) % 7 != 0)
    (lj, mj), gj = jax.value_and_grad(GJ._train_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, spec_j, 2,
        *(jnp.asarray(a) for a in args))
    pt = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    lt, mt = GT._train_loss(pt, spec_t, 2, *(_t(a) for a in args))
    gt = dict(zip(pt, torch.autograd.grad(lt, list(pt.values()))))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-4)
    assert float(mt.detach()) == pytest.approx(float(mj), rel=1e-4)
    for k in params:
        a = np.asarray(gj[k])
        np.testing.assert_allclose(gt[k].numpy(), a, rtol=1e-3,
                                   atol=1e-3 * np.abs(a).max(), err_msg=k)


def test_adam_ema_steps_match_jax():
    """Three steps on the same gradients: a plain one, one whose global
    norm exceeds the clip, one with a NaN (dropped: the state stays)."""
    spec_j = NJ.make_network(2, 33, SMALL)
    params = _jax_params(spec_j, 42)
    rng = np.random.default_rng(8)
    steps = []
    for scale in (0.01, 10.0, 0.01):
        steps.append({k: (scale * rng.normal(size=v.shape)).astype(np.float32)
                      for k, v in params.items()})
    steps[2]["w1"][3, 4] = np.nan
    cfg_j = NJ.AdamConfig.from_json({"decay": 0.95, "nested": {
        "learning_rate": 8e-3, "beta1": 0.9, "beta2": 0.99,
        "epsilon": 1e-15, "l2_reg": 1e-6}})
    cfg_t = NT.AdamConfig.from_json({"decay": 0.95, "nested": {
        "learning_rate": 8e-3, "beta1": 0.9, "beta2": 0.99,
        "epsilon": 1e-15, "l2_reg": 1e-6}})
    assert tuple(cfg_j) == tuple(cfg_t) == tuple(NT.AdamConfig())
    tj = NJ.init_trainer(jax.random.PRNGKey(42), spec_j)
    tt = NT.trainer_from_numpy(params)
    states = []
    for g in steps:
        tj = NJ.adam_ema_step(tj, {k: jnp.asarray(v) for k, v in g.items()},
                              cfg_j)
        tt = NT.adam_ema_step(tt, {k: _t(v) for k, v in g.items()}, cfg_t)
        got = NT.trainer_to_numpy(tt)
        assert got["count"] == int(tj.opt.count)
        for field, tree in (("params", tj.params),
                            ("ema_params", tj.ema_params),
                            ("mu", tj.opt.mu), ("nu", tj.opt.nu)):
            for k in params:
                np.testing.assert_allclose(got[field][k],
                                           np.asarray(tree[k]), rtol=1e-5,
                                           atol=1e-6, err_msg=(field, k))
        states.append(got)
    assert states[2]["count"] == states[1]["count"] == 2
    for k in params:
        np.testing.assert_array_equal(states[2]["params"][k],
                                      states[1]["params"][k])
    # the clipped step moved no parameter by more than lr (Adam's bound)
    for k in params:
        assert np.abs(states[1]["params"][k]
                      - states[0]["params"][k]).max() <= 8e-3 * 1.01


def test_trainer_round_trip_and_init():
    """trainer_from_numpy / trainer_to_numpy keep every array; the port's
    own init draws the JAX shapes with Glorot bounds, the same on every
    call."""
    spec = NT.make_network(2, 33, SMALL)
    a = NT.init_trainer(spec, torch.device("cpu"))
    b = NT.init_trainer(spec, torch.device("cpu"))
    na, nb = NT.trainer_to_numpy(a), NT.trainer_to_numpy(b)
    spec_j = NJ.make_network(2, 33, SMALL)
    pj = _jax_params(spec_j, 0)
    assert {k: v.shape for k, v in na["params"].items()} == {
        k: v.shape for k, v in pj.items()}
    for k in pj:
        np.testing.assert_array_equal(na["params"][k], nb["params"][k])
        if k.startswith("w"):
            bound = np.sqrt(6.0 / sum(pj[k].shape))
            assert np.abs(na["params"][k]).max() <= bound
    rt = NT.trainer_to_numpy(NT.trainer_from_numpy(
        na["params"], na["ema_params"], na["mu"], na["nu"], count=3))
    assert rt["count"] == 3
    for f in ("params", "ema_params", "mu", "nu"):
        for k in pj:
            np.testing.assert_array_equal(rt[f][k], na[f][k])
