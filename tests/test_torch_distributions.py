"""The PyTorch port's distributions (``elaina_tpu_torch/solver/
distributions.py``) against the literal goldens of the JAX package's tests
and against ``elaina_tpu.solver.distributions`` itself.

The goldens are those of ``tests/test_distributions.py`` and
``tests/test_vmm_goldens.py`` (the reference's Catch2 suites), with their
tolerances.  The deterministic functions get identical seeded numpy inputs
on both sides; their tolerance is XLA-CPU's 1e-4 relative floor on
``log`` / ``exp`` (its fast approximations), plus, where the
value is exp of a large exponent, 4 float32 ulps of that exponent times
kappa (``_exp_tolerance``, the conditioning as ``tests/test_torch_queries.
py``'s ``_pdf_tolerance`` scales it).  The samplers are fed JAX's own
uniforms, drawn with the key splits the JAX function makes, and must give
the same angles and directions to 1e-4; with the port's own generator
they are checked by their moments and their densities' normalization.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.solver import distributions as DJ  # noqa: E402
from elaina_tpu_torch.solver import distributions as DT  # noqa: E402

ULP = float(np.finfo(np.float32).eps)
M_PI_4 = math.pi / 4.0


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _exp_tolerance(kappa, value):
    """1e-4 relative plus 4 ulps of a kappa-sized exponent, relative."""
    return (1e-4 + 4 * ULP * np.abs(kappa)) * np.abs(value) + 1e-7


# --------------------------------------------------------------------------- #
# goldens (tests/test_distributions.py, tests/test_vmm_goldens.py)
# --------------------------------------------------------------------------- #


def test_log_bessel_goldens():
    # test/vonmises_test.cu:11-22
    got = DT.log_bessel_i(_t([1.0, 2.0, 3.0, 4.0]), 0).numpy()
    np.testing.assert_allclose(
        got, [0.23591432, 0.82399356, 1.58530772, 2.42497277], rtol=2e-4)


def test_von_mises_log_prob_goldens():
    # test/vonmises_test.cu:49-70: kappa 4.2, angles -2..2
    cos = torch.cos(_t([-2.0, -1.0, 0.0, 1.0, 2.0]))
    kappa = _t(4.2)
    np.testing.assert_allclose(
        DT.vm_log_eval(cos, kappa).numpy(),
        [-6.18411160, -2.16702533, -0.23629522, -2.16702533, -6.18411160],
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        DT.vm_eval(cos, kappa).numpy(),
        [0.00206193, 0.11451776, 0.78954756, 0.11451776, 0.00206193],
        rtol=5e-4)


def test_von_mises_d_log_d_kappa_goldens():
    # test/vonmises_test.cu:124-148
    c = torch.cos(_t(0.5))
    assert float(DT.vm_d_log_eval_d_kappa(c, _t(1.45))) == pytest.approx(
        0.29405486583709717, rel=2e-4)
    assert float(DT.vm_d_log_eval_d_kappa(c, _t(14.5))) == pytest.approx(
        -0.08729398250579834, rel=2e-3, abs=2e-4)


@pytest.mark.parametrize("a,b,x,expected", [
    (1.0, 1.0, 0.5, 1.0), (2.0, 2.0, 0.5, 1.5),
    (0.5, 0.5, 0.5, 0.6366197723675814), (2.0, 5.0, 0.2, 2.4576),
    (5.0, 2.0, 0.8, 2.4576)])
def test_beta_eval_goldens(a, b, x, expected):
    # test/beta_test.cu:6-46
    assert float(DT.beta_eval(_t(x), _t(a), _t(b))) == pytest.approx(
        expected, rel=1e-3)


def test_activation_goldens():
    # train.h:60-79
    assert float(DT.act_exp(_t(20.0))) == pytest.approx(math.exp(15.0),
                                                        rel=1e-4)
    assert float(DT.act_exp(_t(-20.0))) == pytest.approx(math.exp(-10.0),
                                                         rel=1e-4)
    assert float(DT.act_logistic(_t(0.0))) == pytest.approx(0.5)


def _vm_pdf_angle(theta, mu, kappa):
    return DT.vm_eval(torch.cos(theta - mu), kappa)


def _vmm_angle_pdf(theta, lam, kappa, mu):
    w = lam / torch.sum(lam)
    return torch.sum(w * _vm_pdf_angle(theta, mu, kappa))


def _params_from_raw(data):
    """distribution_test-era activations: exp / exp / 2 pi sigmoid."""
    raw = _t(data).reshape(-1, 3)
    return (torch.exp(raw[:, 0]), torch.exp(raw[:, 1]),
            2.0 * math.pi * torch.sigmoid(raw[:, 2]))


def _grad(f, *args):
    args = [a.clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(f(*args), args)


def test_vm_kernel_goldens():
    """distribution_test.cu:39-127: the pdf (also with the mean past 2 pi)
    and its derivatives in kappa and in the mean, by autograd."""
    zero, mu, kappa = _t(0.0), _t(M_PI_4), _t(1.45)
    want = 0.27751895785331726
    assert float(_vm_pdf_angle(zero, mu, kappa)) == pytest.approx(want,
                                                                  abs=1e-5)
    assert float(_vm_pdf_angle(zero, _t(M_PI_4 + 2 * math.pi),
                               kappa)) == pytest.approx(want, abs=1e-5)
    (g,) = _grad(lambda k: _vm_pdf_angle(zero, mu, k), kappa)
    assert float(g) == pytest.approx(0.034295544028282166, abs=1e-5)
    (g,) = _grad(lambda m: _vm_pdf_angle(zero, m, kappa), mu)
    assert float(g) == pytest.approx(-0.284541517496109, abs=1e-5)


def test_vmm_goldens():
    """distribution_test.cu:136-176: the one- and two-component mixtures
    from zeros and the 9-element gradient golden."""
    zero = _t(0.0)
    lam, kappa, mu = _params_from_raw([0.0, 0.0, 0.0])
    assert float(_vmm_angle_pdf(zero, lam, kappa, mu)) == pytest.approx(
        0.04624549299478531, abs=1e-5)

    lam, kappa, mu = _params_from_raw([0.0] * 6)
    f = lambda *p: _vmm_angle_pdf(zero, *p)  # noqa: E731
    assert float(f(lam, kappa, mu)) == pytest.approx(0.04624549299478531,
                                                     abs=1e-5)
    out = torch.stack(_grad(f, lam, kappa, mu), -1).reshape(-1).numpy()
    assert out[1] == pytest.approx(0.5 * -0.06688901782035828, abs=1e-5)
    assert out[2] == pytest.approx(0.5 * 4.042909562684827e-09, abs=1e-5)
    assert out[0] == pytest.approx(0.0, abs=1e-5)
    np.testing.assert_allclose(out[:3], out[3:], rtol=1e-3, atol=1e-8)

    data = [-0.3391095697879791, 1.3653955459594727, -0.11165934801101685,
            0.7329881191253662, 1.1205719709396362, -1.145609736442566,
            1.5198860168457031, -0.962236225605011, 1.4103161096572876]
    grads = [-0.016046222299337387, -5.7009561714949086e-05,
             -2.110011519107502e-05, -0.011129779741168022,
             -0.007846416905522346, -0.031608663499355316,
             0.00756735447794199, 0.015586040914058685,
             0.0389787033200264]
    lam, kappa, mu = _params_from_raw(data)
    assert float(f(lam, kappa, mu)) == pytest.approx(0.11850630, abs=1e-5)
    out = torch.stack(_grad(f, lam, kappa, mu), -1).reshape(-1).numpy()
    np.testing.assert_allclose(out, grads, atol=1e-5)


def test_vmm_pdf_matches_angle_form():
    """The production (x, y) mixture against the angle form at one angle
    (tests/test_vmm_goldens.py::TestProductionParity)."""
    raw = np.random.default_rng(7).normal(size=(1, 33)).astype(np.float32)
    vmm = DT.vmm_from_raw(_t(raw), 2)
    theta = 0.37
    p = float(DT.vmm_pdf(vmm, _t([[math.cos(theta), math.sin(theta)]]),
                         2)[0])
    mu_ang = torch.atan2(vmm.mu[0, :, 1], vmm.mu[0, :, 0])
    ref = float(_vmm_angle_pdf(_t(theta), vmm.lam[0], vmm.kappa[0], mu_ang))
    assert p == pytest.approx(ref, rel=1e-4)


# --------------------------------------------------------------------------- #
# against the JAX package on identical inputs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("order", [0, 1])
def test_log_bessel_matches_jax(order):
    x = np.random.default_rng(1).uniform(0.0, 40.0, 4000).astype(np.float32)
    x[:3] = [0.0, 3.75, 1e-7]
    want = np.asarray(DJ.log_bessel_i(jnp.asarray(x), order))
    got = DT.log_bessel_i(_t(x), order).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(DT.bessel_i1_over_i0(_t(x)).numpy(),
                               np.asarray(DJ.bessel_i1_over_i0(
                                   jnp.asarray(x))), rtol=1e-4, atol=1e-6)


def test_component_pdfs_match_jax():
    """vm_eval and vmf_eval over kappa in [0, 200] (and the uniform
    fallbacks below 1e-3 and 1e-5) at random cosines."""
    rng = np.random.default_rng(2)
    n = 4000
    kappa = rng.uniform(0.0, 200.0, n).astype(np.float32)
    kappa[:4] = [0.0, 5e-4, 5e-6, 2e-3]
    cos = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    for fj, ft in ((DJ.vm_eval, DT.vm_eval), (DJ.vmf_eval, DT.vmf_eval)):
        want = np.asarray(fj(jnp.asarray(cos), jnp.asarray(kappa)))
        got = ft(_t(cos), _t(kappa)).numpy()
        np.testing.assert_array_less(np.abs(got - want),
                                     _exp_tolerance(kappa, want))


def test_vmm_from_raw_and_pdfs_match_jax():
    """The mixture's fields from seeded raw outputs (some means degenerate:
    the +x fallback), its pdf and the Neumann-folded pdf."""
    rng = np.random.default_rng(3)
    n = 2000
    raw = (2.0 * rng.normal(size=(n, 33))).astype(np.float32)
    raw[:8, 2:4] = 0.0          # component 0's mean degenerate
    raw[8, 2:4] = [1e-13, 0.0]
    vj = DJ.vmm_from_raw(jnp.asarray(raw), 2)
    vt = DT.vmm_from_raw(_t(raw), 2)
    for name in vj._fields:
        np.testing.assert_allclose(_np(getattr(vt, name)),
                                   np.asarray(getattr(vj, name)), rtol=1e-4,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(vt.mu[:9, 0].numpy(),
                                  np.tile([1.0, 0.0], (9, 1)))
    np.testing.assert_allclose(DT.vmm_selection_prob(_t(raw), 2).numpy(),
                               np.asarray(DJ.vmm_selection_prob(
                                   jnp.asarray(raw), 2)), rtol=1e-6)
    th = rng.uniform(-math.pi, math.pi, n)
    wi = np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32)
    nth = rng.uniform(-math.pi, math.pi, n)
    normal = np.stack([np.cos(nth), np.sin(nth)], -1).astype(np.float32)
    on = rng.random(n) < 0.5
    kmax = np.max(_np(vt.kappa), axis=-1)
    pj = np.asarray(DJ.vmm_pdf(vj, jnp.asarray(wi), 2))
    pt = DT.vmm_pdf(vt, _t(wi), 2).numpy()
    np.testing.assert_array_less(np.abs(pt - pj), _exp_tolerance(kmax, pj))
    ej = np.asarray(DJ.vmm_pdf_effective(vj, jnp.asarray(wi),
                                         jnp.asarray(on),
                                         jnp.asarray(normal), 2))
    et = DT.vmm_pdf_effective(vt, _t(wi), torch.as_tensor(on), _t(normal),
                              2).numpy()
    np.testing.assert_array_less(np.abs(et - ej), _exp_tolerance(kmax, ej))
    assert not np.allclose(ej[on], pj[on])


def test_vmm_3d_pdf_matches_jax():
    rng = np.random.default_rng(4)
    n = 1000
    raw = rng.normal(size=(n, DT.n_dim_output(3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    vj = DJ.vmm_from_raw(jnp.asarray(raw), 3)
    vt = DT.vmm_from_raw(_t(raw), 3)
    pj = np.asarray(DJ.vmm_pdf(vj, jnp.asarray(d), 3))
    pt = DT.vmm_pdf(vt, _t(d), 3).numpy()
    kmax = np.max(_np(vt.kappa), axis=-1)
    np.testing.assert_array_less(np.abs(pt - pj), _exp_tolerance(kmax, pj))


def test_act_exp_gradient_matches_jax():
    """exp(clamp(x)) and its derivative exp(clamp(x)) inside the clamp and
    past both ends, where the true derivative would be 0."""
    x = np.array([-30.0, -10.5, -10.0, -3.0, 0.0, 2.5, 14.9, 15.0, 15.5,
                  40.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(DJ.act_exp))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    y = DT.act_exp(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5)
    assert g[0] > 0 and g[-1] > 0


# --------------------------------------------------------------------------- #
# samplers fed JAX's own uniforms
# --------------------------------------------------------------------------- #


def _kappas(n, seed):
    rng = np.random.default_rng(seed)
    k = np.concatenate([rng.uniform(0.0, 5.0, n // 2),
                        np.exp(rng.uniform(0.0, 6.0, n - n // 2))])
    k[:3] = [0.0, 5e-4, 2e-3]
    return k.astype(np.float32)


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))


def test_vm_sample_angle_matches_jax_on_its_uniforms():
    """vm_sample_angle's key splits: (key, k_uni) = split(key); the trials'
    uniforms from key, the fallback's from k_uni."""
    kappa = _kappas(4096, 5)
    key = jax.random.PRNGKey(11)
    want = np.asarray(DJ.vm_sample_angle(key, jnp.asarray(kappa)))
    k_trials, k_uni = jax.random.split(key)
    u = jax.random.uniform(k_trials, kappa.shape + (DT.VM_TRIALS, 3))
    u_uni = jax.random.uniform(k_uni, kappa.shape)
    got = DT.vm_sample_angle_u(_t(u), _t(u_uni), _t(kappa)).numpy()
    assert np.all((got >= -math.pi) & (got <= math.pi))
    assert _angle_diff(got, want).max() < 1e-4


@pytest.mark.parametrize("dim", [2, 3])
def test_vmm_sample_matches_jax_on_its_uniforms(dim):
    """vmm_sample's key splits: (k_sel, k_dir) = split(key), the component
    uniform from k_sel; in 2D vm_sample_angle's splits of k_dir, in 3D
    vmf_sample_local's (k1, k2) = split(k_dir)."""
    rng = np.random.default_rng(6 + dim)
    n = 4096
    raw = (1.5 * rng.normal(size=(n, DT.n_dim_output(dim)))).astype(
        np.float32)
    key = jax.random.PRNGKey(20 + dim)
    want = np.asarray(DJ.vmm_sample(key, DJ.vmm_from_raw(jnp.asarray(raw),
                                                         dim), dim))
    k_sel, k_dir = jax.random.split(key)
    u_sel = jax.random.uniform(k_sel, (n,))
    k_a, k_b = jax.random.split(k_dir)
    if dim == 2:
        u_dir = jax.random.uniform(k_a, (n, DT.VM_TRIALS, 3))
    else:
        u_dir = jax.random.uniform(k_a, (n,))
    u_dir2 = jax.random.uniform(k_b, (n,))
    got = DT.vmm_sample_u(DT.vmm_from_raw(_t(raw), dim), dim, _t(u_sel),
                          _t(u_dir), _t(u_dir2)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # a direction's error: its angle to JAX's (1e-4 rad)
    assert np.max(np.linalg.norm(got - want, axis=-1)) < 1e-4


def test_gamma_sample_matches_jax_on_its_draws():
    """gamma_sample's draws: (key, k_boost) = split(key), then each trial
    splits (key, k1, k2) = split(key, 3) and draws a normal from k1 and a
    uniform from k2.  The JAX loop stops once every lane accepted; the
    port runs every trial, which leaves accepted lanes as they were."""
    shape_param = np.array([0.3, 0.5, 1.0, 2.0, 5.0, 40.0] * 100, np.float32)
    key = jax.random.PRNGKey(13)
    want = np.asarray(DJ.gamma_sample(key, jnp.asarray(shape_param)))
    k, k_boost = jax.random.split(key)
    z, u = [], []
    for _ in range(DT.GAMMA_ITERS):
        k, k1, k2 = jax.random.split(k, 3)
        z.append(np.asarray(jax.random.normal(k1, shape_param.shape)))
        u.append(np.asarray(jax.random.uniform(k2, shape_param.shape)))
    got = DT.gamma_sample_u(_t(z), _t(u), _t(jax.random.uniform(
        k_boost, shape_param.shape)), _t(shape_param)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-30)


# --------------------------------------------------------------------------- #
# moments and normalization with the port's own generator
# --------------------------------------------------------------------------- #


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("kappa,n,tol", [(145.0, 10_000, 0.05),
                                         (1.45, 200_000, 0.02)])
def test_von_mises_sampler_stats(kappa, n, tol):
    # test/vonmises_test.cu:72-122: circular mean ~ 0, variance 1 - I1/I0
    theta = DT.vm_sample_angle(_gen(42), torch.full((n,), kappa)).numpy()
    c, s = np.mean(np.cos(theta)), np.mean(np.sin(theta))
    assert abs(math.atan2(s, c)) < 0.1
    theoretical = 1.0 - float(DT.bessel_i1_over_i0(_t(kappa)))
    assert 1.0 - math.hypot(c, s) == pytest.approx(theoretical, rel=tol,
                                                   abs=1e-3)


def test_vm_and_vmf_pdfs_normalize():
    theta = torch.linspace(-math.pi, math.pi, 4097)[:-1]
    for kappa in (0.0, 0.5, 1.45, 14.5, 145.0):
        p = DT.vm_eval(torch.cos(theta), _t(kappa))
        assert float(p.mean()) * 2 * math.pi == pytest.approx(1.0, rel=2e-3)
    c = torch.linspace(-1.0, 1.0, 200_001)
    for kappa in (0.0, 1.0, 10.0, 100.0):
        p = DT.vmf_eval(c, _t(kappa))
        assert float(torch.trapezoid(p, c)) * 2 * math.pi == pytest.approx(
            1.0, rel=2e-3)


def test_vmf_sampler_mean_cosine():
    s = DT.vmf_sample_local(_gen(1), torch.full((100_000,), 5.0))
    assert float(s[:, 2].mean()) == pytest.approx(
        1.0 / math.tanh(5.0) - 1.0 / 5.0, abs=5e-3)
    np.testing.assert_allclose(torch.linalg.norm(s, dim=-1).numpy(), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("a,b", [(2.0, 5.0), (0.5, 0.5), (5.0, 2.0)])
def test_beta_sampler_moments(a, b):
    n = 100_000
    x = DT.beta_sample(_gen(7), torch.full((n,), a),
                       torch.full((n,), b)).numpy()
    assert np.all((x >= 0) & (x <= 1))
    assert x.mean() == pytest.approx(a / (a + b), abs=6e-3)
    assert x.var() == pytest.approx(a * b / ((a + b) ** 2 * (a + b + 1)),
                                    rel=0.05)


def _lanes(vmm, i, n):
    """Mixture ``i`` of ``vmm`` repeated on n lanes."""
    return DT.VMM(*(None if f is None else f[i:i + 1].expand(
        (n,) + f.shape[1:]) for f in vmm))


def test_vmm_normalizes_and_samples_its_pdf():
    """A 2D mixture integrates to 1 on the circle and its samples'
    histogram follows its pdf; a 3D one integrates to 1 on the sphere."""
    raw = 0.5 * torch.randn((4, DT.n_dim_output(2)), generator=_gen(11))
    vmm = DT.vmm_from_raw(raw, 2)
    theta = torch.linspace(-math.pi, math.pi, 2049)[:-1]
    dirs = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    for i in range(4):
        one = _lanes(vmm, i, len(dirs))
        p = DT.vmm_pdf(one, dirs, 2)
        assert float(p.mean()) * 2 * math.pi == pytest.approx(1.0, rel=5e-3)
    n = 200_000
    big = _lanes(vmm, 0, n)
    s = DT.vmm_sample(_gen(5), big, 2).numpy()
    hist, edges = np.histogram(np.arctan2(s[:, 1], s[:, 0]), bins=64,
                               range=(-math.pi, math.pi), density=True)
    centers = torch.as_tensor(0.5 * (edges[1:] + edges[:-1]),
                              dtype=torch.float32)
    cd = torch.stack([torch.cos(centers), torch.sin(centers)], -1)
    want = DT.vmm_pdf(_lanes(vmm, 0, 64), cd, 2).numpy()
    np.testing.assert_allclose(hist, want, atol=0.05, rtol=0.2)

    raw3 = 0.3 * torch.randn((1, DT.n_dim_output(3)), generator=_gen(2))
    v3 = DT.vmm_from_raw(raw3, 3)
    d = torch.randn((200_000, 3), generator=_gen(3))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    p = DT.vmm_pdf(_lanes(v3, 0, len(d)), d, 3)
    assert float(p.mean()) * 4 * math.pi == pytest.approx(1.0, rel=3e-2)
