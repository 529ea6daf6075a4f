"""Multiresolution dense-grid feature encoding.

Port of ``elaina_tpu/nn/encoding.py`` (the tiny-cuda-nn DenseGrid the
guided integrator configures: data/ladybug/n.json:50-57, base resolution
8, 8 levels, 4 features a level, per-level scale 1.405, linear
interpolation).  Level l has floor(base * scale^l) cells a side and
(res + 1)^dim feature vertices; the features are interpolated at the
normalized query point in [0, 1]^dim.  All levels' vertices are rows of
one table.

The 2D levels are read directly: four corner rows a level, weighted
bilinearly (the JAX package's ``_grid_encode_gather``), every level in one
gather per corner (``torch.take`` of the rows' features from the flat
table).  The TPU's tent-weight matmul form
(``_grid_encode_2d_separable``) is not ported; the two give the same
values to float32 rounding.  Hashed levels (HashGrid levels above
2^log2_hashmap_size vertices) hash the corner as instant-ngp does.  The
3D tri-plane form waits for the ROADMAP item 'guided 3D'.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch


class GridEncodingSpec(NamedTuple):
    dim: int
    n_levels: int
    n_features: int
    resolutions: tuple          # per-level cell counts
    offsets: tuple              # per-level first row in the table
    level_sizes: tuple          # per-level rows (dense: (res + 1)^dim)
    hashed: tuple               # per-level bool: hashed or dense index
    n_params: int               # rows of the table
    triplane: bool = False      # 3D dense levels as three planes

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


# large primes for spatial hashing (instant-ngp convention)
_HASH_PRIMES = (1, 2_654_435_761, 805_459_861)
TABLE_INIT_SCALE = 1e-4   # half-width of the table's uniform init
_MASK32 = (1 << 32) - 1


def make_grid_encoding(dim: int, conf: dict) -> GridEncodingSpec:
    """DenseGrid or HashGrid (tcnn otypes).  HashGrid levels whose dense
    vertex count exceeds 2**log2_hashmap_size take hashed lookups; 3D
    DenseGrid levels are tri-plane levels of 3 (res + 1)^2 rows, as in
    the JAX package."""
    base = int(conf.get("base_resolution", 8))
    n_levels = int(conf.get("n_levels", 8))
    n_features = int(conf.get("n_features_per_level", 4))
    scale = float(conf.get("per_level_scale", 1.405))
    otype = str(conf.get("otype", "DenseGrid")).lower()
    hash_cap = 2 ** int(conf.get("log2_hashmap_size", 19))

    resolutions = tuple(int(math.floor(base * scale ** l))
                        for l in range(n_levels))
    triplane = dim == 3 and "hash" not in otype
    offsets, sizes, hashed = [], [], []
    total = 0
    for r in resolutions:
        dense = 3 * (r + 1) ** 2 if triplane else (r + 1) ** dim
        if "hash" in otype and dense > hash_cap:
            sizes.append(hash_cap)
            hashed.append(True)
        else:
            sizes.append(dense)
            hashed.append(False)
        offsets.append(total)
        total += sizes[-1]
    return GridEncodingSpec(dim=dim, n_levels=n_levels, n_features=n_features,
                            resolutions=resolutions, offsets=tuple(offsets),
                            level_sizes=tuple(sizes), hashed=tuple(hashed),
                            n_params=total, triplane=triplane)


def init_grid_params(gen: torch.Generator,
                     spec: GridEncodingSpec) -> torch.Tensor:
    """tcnn-style small uniform init of the table, +-TABLE_INIT_SCALE, on
    ``gen``'s device."""
    u = torch.rand((spec.n_params, spec.n_features), generator=gen,
                   device=gen.device)
    return (2.0 * u - 1.0) * TABLE_INIT_SCALE


@functools.lru_cache(maxsize=16)
def _level_tables(spec: GridEncodingSpec, device: torch.device):
    """Per-level constants on ``device``, made once a (spec, device):
    (res (L,) float, res - 1 (L,) int64, res + 1 (L,) int64, first row
    (L,) int64, rows (L,) int64, hashed (L,) bool, the feature ids (F,))."""
    res = spec.resolutions
    return (torch.tensor(res, dtype=torch.float32, device=device),
            torch.tensor([r - 1 for r in res], device=device),
            torch.tensor([r + 1 for r in res], device=device),
            torch.tensor(spec.offsets, device=device),
            torch.tensor(spec.level_sizes, device=device),
            torch.tensor(spec.hashed, device=device),
            torch.arange(spec.n_features, device=device))


def grid_encode(spec: GridEncodingSpec, table: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x: (N, 2) normalized coordinates (clamped to [0, 1]) ->
    (N, n_levels * n_features), level-major."""
    if spec.dim != 2:
        raise NotImplementedError(
            "a 3D grid encoding (the tri-plane levels) arrives with the "
            "ROADMAP item 'guided 3D'")
    n, nf = x.shape[0], spec.n_features
    res_f, res_m1, res_p1, first, rows, hashed, feat_ids = _level_tables(
        spec, x.device)
    flat = table.reshape(-1)
    x = torch.clamp(x, 0.0, 1.0)
    pos = x[:, None, :] * res_f[None, :, None]               # (N, L, 2)
    i0 = torch.minimum(pos.to(torch.int64), res_m1[None, :, None])
    i0 = torch.clamp(i0, min=0)
    frac = pos - i0.to(pos.dtype)
    feat = None
    for cx, cy in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ix = i0[..., 0] + cx
        iy = i0[..., 1] + cy
        lin = ix * res_p1 + iy
        if any(spec.hashed):
            h = ix ^ ((iy * _HASH_PRIMES[1]) & _MASK32)
            lin = torch.where(hashed, h % rows, lin)
        w = ((frac[..., 0] if cx else 1.0 - frac[..., 0])
             * (frac[..., 1] if cy else 1.0 - frac[..., 1]))
        # a flat gather of each feature: on the H100, index_select,
        # embedding and row-wise gathers of these 16-byte rows all ran
        # ~30x slower per element than torch.take (PERF.md §6)
        corner = torch.take(flat, (first + lin)[..., None] * nf + feat_ids)
        term = w[..., None] * corner
        feat = term if feat is None else feat + term
    return feat.reshape(n, spec.out_dim)
