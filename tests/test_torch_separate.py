"""The port's ``_separate`` (star radius and epsilon-shell test on the
K1-K3 resolve) against ``elaina_tpu.solver.wost._separate``: the generic
chain path, and at 1024 lanes also the fast bitmask path in Pallas
interpret mode (about 20 s on one CPU core at 1024 lanes, twice that at
4096).  The asserts are those of
``tests/test_grid.py::test_fused_resolve_matches_chain_path``, plus
agreement of the port's radii and colors with the JAX fast path."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry.primitives import seg_closest_point  # noqa: E402
from elaina_tpu.solver import wost as W  # noqa: E402
from elaina_tpu_torch.solver import wost as TW  # noqa: E402

EPS = 0.35


@pytest.fixture(scope="module")
def scenes():
    from test_grid import _fast_path_scene
    from test_torch_resolve import port_scene_of

    scene_fast, scene_ref, verts, idx = _fast_path_scene(EPS)
    return scene_fast, scene_ref, port_scene_of(scene_fast, verts, idx), \
        verts, idx


@pytest.mark.parametrize("n", [1024, 4096])
def test_separate_matches_jax(n, scenes):
    scene_fast, scene_ref, scene_port, verts, idx = scenes
    q = np.random.default_rng(17).uniform(-5, 5, (n, 2)).astype(np.float32)
    act = np.arange(n) % 7 != 0
    state = W.init_walk_state(jnp.asarray(q), jnp.asarray(act))

    fast = n == 1024
    if fast:
        os.environ["ELAINA_PALLAS_INTERPRET"] = "1"
        try:
            assert W.fast_dirichlet_available(scene_fast, EPS)
            in_f, RB_f, col_f, RD_f = (np.asarray(a) for a in W._separate(
                scene_fast, state, EPS, 32, shrink=True))
        finally:
            os.environ["ELAINA_PALLAS_INTERPRET"] = "0"
    in_r, RB_r, col_r, _ = (np.asarray(a) for a in W._separate(
        scene_ref, state, EPS, 32, shrink=True))

    st = TW.init_walk_state(torch.as_tensor(q), torch.as_tensor(act))
    in_p, RB_p, col_p, RD_p, need_p = (a.numpy() for a in TW._separate(
        scene_port, st, EPS, shrink=True))
    assert not (need_p & ~act).any() and (need_p | ~in_p).all()

    a, b = verts[idx[:, 0]][None], verts[idx[:, 1]][None]
    d_true = np.asarray(jnp.min(seg_closest_point(q[:, None, :], a, b)[0],
                                axis=1))

    # identical in-shell classification
    np.testing.assert_array_equal(in_p & act, in_r & act)
    # in-shell lanes carry the exact distance
    np.testing.assert_allclose(RD_p[in_p & act], d_true[in_p & act],
                               rtol=1e-5, atol=1e-5)
    # everywhere active: a valid lower bound that keeps the walk correct
    assert np.all(RD_p[act] <= d_true[act] + 1e-4)
    # no active lane inside the true shell may be missed
    assert np.all(~(act & (d_true < EPS * 0.999) & in_r) | in_p)
    # colors agree on in-shell lanes, and are 0 elsewhere
    np.testing.assert_allclose(col_p[in_p & act], col_r[in_p & act],
                               rtol=1e-5, atol=1e-5)
    assert (col_p[~in_p] == 0).all()
    # star radii: a valid (possibly smaller) radius than the chain path's
    assert np.all(RB_p[act] <= RB_r[act] + 1e-4)
    if fast:
        # the JAX fast path: same shell, colors, radii and distances
        np.testing.assert_array_equal(in_p & act, in_f & act)
        np.testing.assert_allclose(col_p[in_p & act], col_f[in_p & act],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(RB_p[act], RB_f[act], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(RD_p[act], RD_f[act], rtol=1e-5,
                                   atol=1e-5)


def test_separate_rejects_other_eps(scenes):
    """The FinePack's need bit is baked with one eps: another eps raises
    instead of silently using stale bits."""
    _, _, scene_port, _, _ = scenes
    st = TW.init_walk_state(torch.zeros((8, 2)),
                            torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        TW._separate(scene_port, st, EPS * 0.9, shrink=True)
