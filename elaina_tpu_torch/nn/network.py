"""Guiding network: grid encoding + MLP, trained with Adam + parameter EMA.

Port of ``elaina_tpu/nn/network.py`` (reference: GuidingNetwork<T>,
util/network.h:21-196, and the tcnn Ema(Adam) optimizer,
guided/integrator.cu:1113-1119, data/ladybug/n.json:61-80).  Parameters
are a dict named as the JAX package's (``table``, ``w{i}`` stored
(fan_in, fan_out), ``b{i}``), so that a JAX parameter dict carries over
name for name (``trainer_from_numpy``).

Each layer rounds its input and weight to bf16 and multiplies them in
float32 (``jnp.dot(..., preferred_element_type=f32)``): products of bf16
values are exact in float32, and the sum accumulates in float32.  The
backward is the JAX one read from the jaxpr of ``jax.grad``: the weight
and input cotangents are float32 products of the float32 cotangent with
the bf16 operands, each rounded to bf16.  TF32 (10 mantissa bits) leaves
a bf16 operand (7 bits) as it is, so the forward is the same either way,
but it would round the backward's float32 cotangent: the guide needs
float32 matmuls on the card in IEEE float32, PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32`` False).  The port sets no
process-wide flag; ``require_ieee_matmul`` raises where TF32 is on.

``adam_ema_step`` is the JAX update step for step (not ``torch.optim``):
l2 added to the gradient, the global norm clipped at 0.5, bias-corrected
Adam, the EMA of the parameters, and a batch with a nonfinite gradient
dropped by ``torch.where`` (no read back to the host).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .encoding import (GridEncodingSpec, grid_encode, init_grid_params,
                       make_grid_encoding)

GRAD_CLIP = 0.5      # global-norm clip of a gradient batch
INIT_SEED = 42       # the network's initialization seed (pkey(42))


class NetworkSpec(NamedTuple):
    encoding: GridEncodingSpec
    n_neurons: int
    n_hidden: int
    n_out: int


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor     # 0-dim int32


class TrainerState(NamedTuple):
    params: dict
    ema_params: dict
    opt: AdamState


def make_network(dim: int, n_out: int, conf: dict) -> NetworkSpec:
    enc = make_grid_encoding(dim, conf.get("encoding", {}))
    net = conf.get("network", {})
    return NetworkSpec(encoding=enc, n_neurons=int(net.get("n_neurons", 64)),
                       n_hidden=int(net.get("n_hidden_layers", 3)),
                       n_out=n_out)


def init_params(gen: torch.Generator, spec: NetworkSpec) -> dict:
    """The table (uniform +-1e-4) and Glorot-uniform weights, zero biases,
    drawn from ``gen`` on its device."""
    params = {"table": init_grid_params(gen, spec.encoding)}
    dims = ([spec.encoding.out_dim] + [spec.n_neurons] * (spec.n_hidden + 1)
            + [spec.n_out])
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=gen, device=gen.device)
        params[f"w{i}"] = (2.0 * u - 1.0) * bound
        params[f"b{i}"] = torch.zeros((fan_out,), device=gen.device)
    return params


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), held as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


class _Bf16Matmul(torch.autograd.Function):
    """x @ w on bf16-rounded operands, accumulated and returned in
    float32; the cotangents as JAX's transpose rule gives them."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = _bf16(x), _bf16(w)
        ctx.save_for_backward(xb, wb)
        return xb @ wb

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        return _bf16(g @ wb.T), _bf16(xb.T @ g)


def require_ieee_matmul():
    """Raise if float32 matmuls on the card may take TF32 (the setting of
    ``torch.backends.cuda.matmul.allow_tf32``, or ``fp32_precision`` where
    this PyTorch has it: reading the legacy flag raises once the new one
    was set)."""
    flags = torch.backends.cuda.matmul
    if hasattr(flags, "fp32_precision"):
        tf32 = flags.fp32_precision == "tf32"
    else:
        tf32 = flags.allow_tf32
    if tf32:
        raise RuntimeError(
            "the guiding network's backward needs IEEE float32 matmuls: "
            "set torch.backends.cuda.matmul.allow_tf32 = False")


def apply_network(spec: NetworkSpec, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """x: (N, dim) normalized positions -> raw outputs (N, n_out), float32."""
    h = grid_encode(spec.encoding, params["table"], x)
    n_layers = spec.n_hidden + 2
    for i in range(n_layers):
        h = _Bf16Matmul.apply(h, params[f"w{i}"]) + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


class GuidingNetwork(nn.Module):
    """The guide as a module: the table and the layers ``w{i}``, ``b{i}``
    as parameters of the JAX names, sharing the tensors they are given."""

    def __init__(self, spec: NetworkSpec, params: dict):
        super().__init__()
        self.spec = spec
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_network(self.spec, dict(self.named_parameters()), x)


class AdamConfig(NamedTuple):
    lr: float = 8e-3
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-15
    l2_reg: float = 1e-6
    ema_decay: float = 0.95

    @classmethod
    def from_json(cls, conf: dict | None) -> "AdamConfig":
        """The tcnn Ema{nested: Adam} optimizer config (n.json:68-80)."""
        conf = conf or {}
        decay = float(conf.get("decay", 0.95))
        nested = conf.get("nested", conf)
        return cls(lr=float(nested.get("learning_rate", 8e-3)),
                   beta1=float(nested.get("beta1", 0.9)),
                   beta2=float(nested.get("beta2", 0.99)),
                   eps=float(nested.get("epsilon", 1e-15)),
                   l2_reg=float(nested.get("l2_reg", 1e-6)),
                   ema_decay=decay)


def _zeros_like(params: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def init_trainer(spec: NetworkSpec, device: torch.device) -> TrainerState:
    """Parameters drawn on the CPU from INIT_SEED (the same on every
    device), moved to ``device``; EMA = parameters, zero moments."""
    gen = torch.Generator().manual_seed(INIT_SEED)
    params = {k: v.to(device) for k, v in init_params(gen, spec).items()}
    return TrainerState(params=params, ema_params=params,
                        opt=AdamState(mu=_zeros_like(params),
                                      nu=_zeros_like(params),
                                      count=torch.zeros((), dtype=torch.int32,
                                                        device=device)))


def adam_ema_step(state: TrainerState, grads: dict, cfg: AdamConfig,
                  apply: torch.Tensor | None = None) -> TrainerState:
    """One optimizer step (guided/train.h:422-471 through tcnn's Adam and
    Ema).  A batch with a nonfinite gradient leaves the state as it was
    (the reference has no such guard), and so does ``apply`` (a 0-dim
    bool) False; the gradient's global norm is clipped at GRAD_CLIP."""
    names = sorted(grads)                   # the JAX tree's leaf order
    keep = torch.stack([torch.isfinite(grads[k]).all()
                        for k in names]).all()
    if apply is not None:
        keep = keep & apply
    count = state.opt.count + 1
    t = count.to(torch.float32)
    gnorm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in names))
    scale = torch.clamp(GRAD_CLIP / torch.clamp(gnorm, min=1e-20), max=1.0)
    bc1 = 1 - torch.pow(cfg.beta1, t)
    bc2 = 1 - torch.pow(cfg.beta2, t)
    params, mu, nu, ema = {}, {}, {}, {}
    for k in names:
        p, m, v = state.params[k], state.opt.mu[k], state.opt.nu[k]
        g = grads[k] * scale + cfg.l2_reg * p
        m2 = cfg.beta1 * m + (1 - cfg.beta1) * g
        v2 = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        p2 = p - cfg.lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        e2 = (cfg.ema_decay * state.ema_params[k]
              + (1 - cfg.ema_decay) * p2)
        params[k] = torch.where(keep, p2, p)
        mu[k] = torch.where(keep, m2, m)
        nu[k] = torch.where(keep, v2, v)
        ema[k] = torch.where(keep, e2, state.ema_params[k])
    return TrainerState(params=params, ema_params=ema,
                        opt=AdamState(mu=mu, nu=nu,
                                      count=torch.where(keep, count,
                                                        state.opt.count)))


def trainer_from_numpy(params: dict, ema_params: dict | None = None,
                       mu: dict | None = None, nu: dict | None = None,
                       count: int = 0,
                       device: torch.device = torch.device("cpu")
                       ) -> TrainerState:
    """The port's TrainerState from numpy arrays named as the JAX
    package's (``TrainerState.params``, ``.ema_params``, ``.opt.mu``,
    ``.opt.nu``, ``.opt.count``): EMA defaults to the parameters, the
    moments to zeros."""
    def dev(d):
        return {k: torch.tensor(np.asarray(v, np.float32), device=device)
                for k, v in d.items()}

    p = dev(params)
    return TrainerState(
        params=p, ema_params=p if ema_params is None else dev(ema_params),
        opt=AdamState(mu=_zeros_like(p) if mu is None else dev(mu),
                      nu=_zeros_like(p) if nu is None else dev(nu),
                      count=torch.tensor(int(count), dtype=torch.int32,
                                         device=device)))


def trainer_to_numpy(state: TrainerState) -> dict:
    """The state as numpy: params, ema_params, mu, nu (dicts) and count."""
    def host(d):
        return {k: v.detach().cpu().numpy() for k, v in d.items()}

    return {"params": host(state.params), "ema_params": host(state.ema_params),
            "mu": host(state.opt.mu), "nu": host(state.opt.nu),
            "count": int(state.opt.count)}
