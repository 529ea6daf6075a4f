"""Directional and radial distributions for walk guiding.

Port of ``elaina_tpu/solver/distributions.py`` (reference:
util/vonmises.h, util/vmf.h, util/beta.h, integrator/guided/train.h:50-106
and integrator/guided/distribution.h:133-444): the modified-Bessel fits,
the von Mises and von Mises-Fisher densities and samplers, Gamma and Beta,
the network-output activations and the vMF mixture (VMM).

Every sampler comes in two forms: ``*_u`` takes its uniforms (or normals)
as tensors, in the shapes and order the JAX function draws them, and the
plain form draws them from a ``torch.Generator`` (Philox on the card) and
calls it.  The tests feed the ``*_u`` forms JAX's own draws.

The von Mises sampler keeps the reference port's FIXED 8 Best-Fisher
trials: a lane that accepts none takes its last proposal (< 2e-4 of lanes
at any kappa), so a loop until acceptance would change the distribution's
tail.  The Gamma sampler runs its GAMMA_ITERS Marsaglia-Tsang trials on
every lane with no early exit, which gives the JAX loop's values for the
same draws without reading the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.mathops import (frame_from_normal, frame_from_tangent_2d,
                             reflect, to_world)

M_2PI = 2.0 * math.pi
M_4PI = 4.0 * math.pi
M_EPSILON = 1e-5  # krrmath/constants.h:19
VM_TRIALS = 8     # Best-Fisher trials of vm_sample_angle
GAMMA_ITERS = 64  # Marsaglia-Tsang trials of gamma_sample

# ---------------------------------------------------------------------------
# Modified Bessel functions I0 / I1 (log), Abramowitz & Stegun 9.8.1-9.8.4,
# the float32 coefficients of the JAX package (util/vonmises.h:18-93)
# ---------------------------------------------------------------------------


def _f32(values) -> tuple:
    """Python floats holding the float32 roundings of ``values``."""
    return tuple(float(v) for v in torch.tensor(values, dtype=torch.float32))


_I0_SMALL = _f32([1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732,
                  0.360768e-1, 0.45813e-2])
_I1_SMALL = _f32([0.5, 0.87890594, 0.51498869, 0.15084934, 0.2658733e-1,
                  0.301532e-2, 0.32411e-3])
_I0_LARGE = _f32([0.39894228, 0.1328592e-1, 0.225319e-2, -0.157565e-2,
                  0.916281e-2, -0.2057706e-1, 0.2635537e-1, -0.1647633e-1,
                  0.392377e-2])
_I1_LARGE = _f32([0.39894228, -0.3988024e-1, -0.362018e-2, 0.163801e-2,
                  -0.1031555e-1, 0.2282967e-1, -0.2895312e-1, 0.1787654e-1,
                  -0.420059e-2])


def _eval_poly(y, coeffs):
    """Horner evaluation, matching evalPoly (util/vonmises.h:64-73)."""
    ret = coeffs[-1]
    for c in coeffs[-2::-1]:
        ret = c + y * ret
    return ret


def log_bessel_i(x: torch.Tensor, order: int = 0) -> torch.Tensor:
    """log I_order(x) for order in {0, 1} (util/vonmises.h:75-93)."""
    small_c = _I0_SMALL if order == 0 else _I1_SMALL
    large_c = _I0_LARGE if order == 0 else _I1_LARGE
    y = (x / 3.75) ** 2
    small = _eval_poly(y, small_c)
    if order == 1:
        small = torch.abs(x) * small
    small = torch.log(torch.clamp(small, min=1e-30))
    xs = torch.clamp(x, min=1e-6)  # the large branch where it is not taken
    y2 = 3.75 / xs
    large = (xs - 0.5 * torch.log(xs)
             + torch.log(torch.clamp(_eval_poly(y2, large_c), min=1e-30)))
    return torch.where(x < 3.75, small, large)


def bessel_i1_over_i0(kappa: torch.Tensor) -> torch.Tensor:
    """I1(kappa) / I0(kappa), the mean resultant length of a von Mises."""
    return torch.exp(log_bessel_i(kappa, 1) - log_bessel_i(kappa, 0))


# ---------------------------------------------------------------------------
# von Mises on the circle (2D directions)
# ---------------------------------------------------------------------------


def vm_log_eval(cos_theta, kappa, log_i0=None):
    """log VM pdf against cos(angle to the mean) (util/vonmises.h:128-133);
    ``log_i0``, where given, is log_bessel_i(kappa, 0)."""
    if log_i0 is None:
        log_i0 = log_bessel_i(kappa, 0)
    return kappa * cos_theta - math.log(M_2PI) - log_i0


def vm_eval(cos_theta, kappa, log_i0=None):
    """VM pdf; kappa < 1e-3 falls back to uniform (util/vonmises.h:176-183)."""
    return torch.where(kappa < 1e-3, 1.0 / M_2PI,
                       torch.exp(vm_log_eval(cos_theta, kappa, log_i0)))


def vm_d_log_eval_d_kappa(cos_theta, kappa):
    """d log VM / d kappa = cos(theta) - I1/I0 (util/vonmises.h:135-169)."""
    return cos_theta - bessel_i1_over_i0(kappa)


def vm_d_eval_d_kappa(cos_theta, kappa):
    """util/vonmises.h:171-174."""
    return vm_eval(cos_theta, kappa) * vm_d_log_eval_d_kappa(cos_theta, kappa)


def _vm_proposal_r(kappa):
    """Best-Fisher wrapped-Cauchy proposal parameter (util/vonmises.h:197-204)."""
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * torch.clamp(kappa, min=1e-20))
    r = (1.0 + rho * rho) / (2.0 * torch.clamp(rho, min=1e-20))
    r_taylor = 1.0 / torch.clamp(kappa, min=1e-20) + kappa
    return torch.where(kappa < 1e-5, r_taylor, r)


def _mod(x, y: float):
    """jnp.mod for floats: fmod, moved into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def vm_sample_angle_u(u: torch.Tensor, u_uni: torch.Tensor,
                      kappa: torch.Tensor) -> torch.Tensor:
    """Angles (relative to the mean) from VM(kappa), from the uniforms
    ``u`` (..., T, 3) of T Best-Fisher trials and ``u_uni`` (...) of the
    kappa < 1e-3 fallback (util/vonmises.h:95-118).  The first accepted
    trial wins; a lane that accepts none takes trial T - 1.  Angles lie in
    [-pi, pi)."""
    trials = u.shape[-2]
    r = _vm_proposal_r(kappa)[..., None]
    u1 = u[..., 0]
    u2 = torch.clamp(u[..., 1], min=1e-12)
    u3 = u[..., 2]
    z = torch.cos(math.pi * u1)                       # (..., T)
    f = (1.0 + r * z) / (r + z)
    c = kappa[..., None] * (r - f)
    accept = ((c * (2.0 - c) - u2) > 0.0) | (
        (torch.log(c / u2) + 1.0 - c) >= 0.0)
    first = torch.argmax(accept.to(torch.uint8), dim=-1)
    pick = torch.where(accept.any(dim=-1), first, trials - 1)[..., None]
    f_sel = torch.gather(f, -1, pick)[..., 0]
    u3_sel = torch.gather(u3, -1, pick)[..., 0]
    theta = _mod(torch.sign(u3_sel - 0.5)
                 * torch.arccos(torch.clamp(f_sel, -1.0, 1.0)) + math.pi,
                 M_2PI) - math.pi
    uniform_theta = M_2PI * u_uni - math.pi
    return torch.where(kappa < 1e-3, uniform_theta, theta)


def _rand(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def vm_sample_angle(gen: torch.Generator,
                    kappa: torch.Tensor) -> torch.Tensor:
    """``vm_sample_angle_u`` with its uniforms drawn from ``gen``: the
    VM_TRIALS trials' (..., VM_TRIALS, 3), then the fallback's (...)."""
    shape = tuple(kappa.shape)
    u = _rand(gen, shape + (VM_TRIALS, 3))
    return vm_sample_angle_u(u, _rand(gen, shape), kappa)


def _vm_direction(theta, mu):
    local = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return to_world(2, frame_from_tangent_2d(mu), local)


def vm_sample_u(u, u_uni, kappa, mu):
    """2D unit vectors around the mean direction ``mu``
    (util/vonmises.h:185-194), from the uniforms of ``vm_sample_angle_u``."""
    return _vm_direction(vm_sample_angle_u(u, u_uni, kappa), mu)


def vm_sample(gen: torch.Generator, kappa, mu):
    return _vm_direction(vm_sample_angle(gen, kappa), mu)


# ---------------------------------------------------------------------------
# von Mises-Fisher on S^2 (3D directions), Jakob [2012] stable forms
# (util/vmf.h:27-55)
# ---------------------------------------------------------------------------


def vmf_eval(cos_theta, kappa):
    safe = torch.clamp(kappa, min=M_EPSILON)
    val = torch.exp(safe * torch.clamp(cos_theta - 1.0, max=0.0)) * safe / (
        M_2PI * (1.0 - torch.exp(-2.0 * safe)))
    return torch.where(kappa < M_EPSILON, 1.0 / M_4PI, val)


def vmf_sample_local_u(u0, u1, kappa):
    """vMF around +z from two uniforms a lane; kappa < eps falls back to
    the uniform sphere."""
    safe = torch.clamp(kappa, min=M_EPSILON)
    cos_theta = 1.0 + torch.log1p(-u0 + torch.exp(-2.0 * safe) * u0) / safe
    cos_theta = torch.where(kappa < M_EPSILON, 1.0 - 2.0 * u0, cos_theta)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = M_2PI * u1
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def vmf_sample_local(gen: torch.Generator, kappa, shape=None):
    shape = tuple(kappa.shape) if shape is None else tuple(shape)
    u0 = _rand(gen, shape)
    return vmf_sample_local_u(u0, _rand(gen, shape), kappa)


def vmf_sample_u(u0, u1, kappa, mu):
    return to_world(3, frame_from_normal(3, mu),
                    vmf_sample_local_u(u0, u1, kappa))


def vmf_sample(gen: torch.Generator, kappa, mu):
    return to_world(3, frame_from_normal(3, mu), vmf_sample_local(gen, kappa))


# ---------------------------------------------------------------------------
# Gamma / Beta sampling (util/beta.h:21-80)
# ---------------------------------------------------------------------------


def gamma_sample_u(z, u, u_boost, shape_param):
    """Marsaglia-Tsang Gamma(shape, 1) from the normals ``z`` and uniforms
    ``u`` of its trials (each (iters, ...)) and the boost uniforms
    ``u_boost`` (...): the first accepted trial wins (1.0 where none
    does).  shape < 1 uses Gamma(a) = Gamma(a + 1) U^{1/a} in place of the
    reference's second rejection loop (util/beta.h:46-58)."""
    boosted = torch.where(shape_param < 1.0, shape_param + 1.0, shape_param)
    d = boosted - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.ones_like(shape_param)
    accepted = torch.zeros_like(shape_param, dtype=torch.bool)
    for zi, ui in zip(z, u):
        v = (1.0 + c * zi) ** 3
        ui = torch.clamp(ui, min=1e-12)
        ok = (v > 0.0) & (
            (ui < 1.0 - 0.0331 * zi ** 4)
            | (torch.log(ui) < 0.5 * zi * zi
               + d * (1.0 - v + torch.log(torch.clamp(v, min=1e-30)))))
        out = torch.where(accepted, out, torch.where(ok, d * v, out))
        accepted = accepted | ok
    u_boost = torch.clamp(u_boost, min=1e-12)
    boost = torch.where(
        shape_param < 1.0,
        u_boost ** (1.0 / torch.clamp(shape_param, min=1e-6)), 1.0)
    return out * boost


def gamma_sample(gen: torch.Generator, shape_param):
    shape = tuple(shape_param.shape)
    z = torch.randn((GAMMA_ITERS,) + shape, generator=gen, device=gen.device)
    u = _rand(gen, (GAMMA_ITERS,) + shape)
    return gamma_sample_u(z, u, _rand(gen, shape), shape_param)


def beta_sample(gen: torch.Generator, a, b):
    """Beta(a, b) via two Gammas (util/beta.h:21-28)."""
    ga = gamma_sample(gen, a)
    gb = gamma_sample(gen, b)
    return ga / torch.clamp(ga + gb, min=1e-30)


def beta_eval(x, a, b):
    """Beta pdf (util/beta.h:17-19)."""
    log_norm = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return x ** (a - 1.0) * (1.0 - x) ** (b - 1.0) * torch.exp(-log_norm)


# ---------------------------------------------------------------------------
# Network-output activations (train.h:50-106)
# ---------------------------------------------------------------------------

EXP_CLAMP_MIN = -10.0
EXP_CLAMP_MAX = 15.0


class _ActExp(torch.autograd.Function):
    """exp(clamp(x)) whose derivative is exp(clamp(x)) everywhere, the
    saturated range included (train.h:95-96): saturated components keep
    receiving updates, as in the reference."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, EXP_CLAMP_MIN, EXP_CLAMP_MAX))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def act_exp(x: torch.Tensor) -> torch.Tensor:
    """Exponential activation with clamp (train.h:71-72), for lambda and
    kappa."""
    return _ActExp.apply(x)


def act_logistic(x: torch.Tensor) -> torch.Tensor:
    """Logistic activation (train.h:69-70), for the selection probability."""
    return torch.sigmoid(x)


# ---------------------------------------------------------------------------
# vMF mixture (VMM), distribution.h:133-444.  Raw layout per lane (the
# network output, parameters.h:16-33): [comp k: lambda, kappa, mu_x, mu_y
# (, mu_z)] for k < K, then the selection-probability logit.
# ---------------------------------------------------------------------------

NUM_VMF_COMPONENTS = 8  # parameters.h:18/28


class VMM(NamedTuple):
    lam: torch.Tensor       # (..., K) mixture sizes (post-activation)
    kappa: torch.Tensor     # (..., K)
    mu: torch.Tensor        # (..., K, D) normalized means
    mu_orig: torch.Tensor   # (..., K, D) raw (unnormalized) means
    weight: torch.Tensor    # (..., K) lam / sum(lam)
    log_i0: torch.Tensor | None = None   # (..., K) log I0(kappa), 2D: the
    #                         von Mises normalization, made once a mixture
    #                         for all its pdf evaluations


def n_dim_vmf(dim: int) -> int:
    return dim + 2  # lambda, kappa, coords (parameters.h:21/31)


def n_dim_output(dim: int) -> int:
    return NUM_VMF_COMPONENTS * n_dim_vmf(dim) + 1


def vmm_from_raw(raw: torch.Tensor, dim: int) -> VMM:
    """Activations and the mixture (distribution.h:146-168, 289-312).  A
    raw mean of length <= 1e-12 takes the +x axis."""
    K, P = NUM_VMF_COMPONENTS, n_dim_vmf(dim)
    comp = raw[..., :K * P].reshape(raw.shape[:-1] + (K, P))
    lam = act_exp(comp[..., 0])
    kappa = act_exp(comp[..., 1])
    mu_orig = comp[..., 2:]
    mu_len = torch.sqrt(torch.sum(mu_orig * mu_orig, dim=-1, keepdim=True))
    fallback = torch.zeros_like(mu_orig)
    fallback[..., 0] = 1.0
    mu = torch.where(mu_len > 1e-12,
                     mu_orig / torch.clamp(mu_len, min=1e-12), fallback)
    total = torch.sum(lam, dim=-1, keepdim=True)
    weight = lam / torch.clamp(total, min=1e-30)
    return VMM(lam=lam, kappa=kappa, mu=mu, mu_orig=mu_orig, weight=weight,
               log_i0=log_bessel_i(kappa, 0) if dim == 2 else None)


def vmm_selection_prob(raw: torch.Tensor, dim: int) -> torch.Tensor:
    """Learned guided-vs-uniform selection probability
    (guided/integrator.cu:517)."""
    return act_logistic(raw[..., NUM_VMF_COMPONENTS * n_dim_vmf(dim)])


def _component_pdf(cos_theta, kappa, dim: int, log_i0=None):
    if dim == 2:
        return vm_eval(cos_theta, kappa, log_i0)
    return vmf_eval(cos_theta, kappa)


def vmm_pdf(vmm: VMM, wi: torch.Tensor, dim: int) -> torch.Tensor:
    """Mixture pdf at the directions ``wi`` (..., D)
    (distribution.h:170-178, 314-323)."""
    cos_theta = torch.sum(vmm.mu * wi[..., None, :], dim=-1)   # (..., K)
    return torch.sum(vmm.weight * _component_pdf(cos_theta, vmm.kappa, dim,
                                                 vmm.log_i0), dim=-1)


def vmm_pdf_effective(vmm: VMM, wi, on_neumann, n_normal, dim: int):
    """pdf with the Neumann folding: pdf(wi) + pdf(reflect(wi)) on the
    boundary (guided/integrator.cu:720-722, 828-833)."""
    p = vmm_pdf(vmm, wi, dim)
    p_ref = vmm_pdf(vmm, reflect(wi, n_normal), dim)
    return torch.where(on_neumann, p + p_ref, p)


def vmf_beta_sample(gen: torch.Generator, kappa, mu, alpha, beta, dim: int):
    """Joint direction x radius sample: a von Mises (2D) or vMF (3D)
    direction and a Beta radial fraction (VMFBetaKernel,
    distribution.h:69-131; in the reference but wired into no
    integrator)."""
    direction = (vm_sample(gen, kappa, mu) if dim == 2
                 else vmf_sample(gen, kappa, mu))
    return direction, beta_sample(gen, alpha, beta)


def vmf_beta_pdf(wi, r, kappa, mu, alpha, beta, dim: int):
    """Product pdf of VMFBetaKernel (distribution.h:82-87, 114-119)."""
    cos_theta = torch.sum(wi * mu, dim=-1)
    return _component_pdf(cos_theta, kappa, dim) * beta_eval(r, alpha, beta)


def _pick_component(vmm: VMM, u_sel):
    """The component the CDF walk over the weights picks for the uniform
    ``u_sel`` (...): its kappa (...) and mean (..., D)."""
    # the scan runs along a leading axis: PyTorch's CUDA scan along an
    # innermost axis of 8 took 5.8 ms at 1M lanes, this transpose and scan
    # 0.11 ms (PERF.md §6).  Its sums agree with the innermost scan's to
    # ~1.4e-6, not bit for bit, so a pick at a CDF boundary can differ.
    cdf = torch.cumsum(vmm.weight.movedim(-1, 0).contiguous(), dim=0)
    idx = torch.sum((u_sel[None] >= cdf).to(torch.int64), dim=0)
    idx = torch.clamp(idx, max=NUM_VMF_COMPONENTS - 1)[..., None]
    kappa = torch.gather(vmm.kappa, -1, idx)[..., 0]
    d = vmm.mu.shape[-1]
    mu = torch.gather(vmm.mu, -2,
                      idx[..., None].expand(idx.shape + (d,)))[..., 0, :]
    return kappa, mu


def vmm_sample_u(vmm: VMM, dim: int, u_sel, u_dir, u_dir2):
    """Sample the mixture (distribution.h:186-198, 332-344) from the
    component uniform ``u_sel`` (...) and the component sampler's
    uniforms: in 2D the trials' (..., T, 3) and the fallback's (...), in
    3D the vMF's two (...)."""
    kappa, mu = _pick_component(vmm, u_sel)
    if dim == 2:
        return vm_sample_u(u_dir, u_dir2, kappa, mu)
    return vmf_sample_u(u_dir, u_dir2, kappa, mu)


def vmm_sample(gen: torch.Generator, vmm: VMM, dim: int) -> torch.Tensor:
    """``vmm_sample_u`` with its uniforms drawn from ``gen`` in that order."""
    batch = tuple(vmm.weight.shape[:-1])
    u_sel = _rand(gen, batch)
    if dim == 2:
        u_dir = _rand(gen, batch + (VM_TRIALS, 3))
    else:
        u_dir = _rand(gen, batch)
    return vmm_sample_u(vmm, dim, u_sel, u_dir, _rand(gen, batch))
