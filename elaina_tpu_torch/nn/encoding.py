"""Multiresolution dense-grid feature encoding.

Port of ``elaina_tpu/nn/encoding.py`` (the tiny-cuda-nn DenseGrid the
guided integrator configures: data/ladybug/n.json:50-57, base resolution
8, 8 levels, 4 features a level, per-level scale 1.405, linear
interpolation).  Level l has floor(base * scale^l) cells a side; the
features are interpolated at the normalized query point in [0, 1]^dim.
All levels' vertices are rows of one table.

Every level is read directly: its corner rows, weighted (bi/tri)linearly,
every level at once in flat gathers of the rows' features from the table
(``torch.take``; in 2D one a corner, in 3D one for all corners).  2D levels have (res + 1)^2 vertices.  A 3D
DenseGrid is the JAX package's tri-plane form: each level is
f_xy(x, y) + f_xz(x, z) + f_yz(y, z), plane p of level l the rows
[offset_l + p V^2, offset_l + (p + 1) V^2), row-major u V + v with
(u, v) = ((x, y), (x, z), (y, z))[p] and V = res + 1, so that a JAX
table carries over row for row.  A 3D HashGrid's levels are volumetric,
(res + 1)^3 vertices, or hashed above 2^log2_hashmap_size (the corner
hashed as instant-ngp does, as are a 2D HashGrid's).  The TPU's
tent-weight matmul forms (``_grid_encode_2d_separable``,
``_grid_encode_3d_triplane``) are not ported, nor the JAX package's A/B
switches ``ELAINA_ENC3D`` and ``ELAINA_ENC_BF16``; the direct reads give
the same values to float32 rounding.
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
    """x: (N, dim) normalized coordinates (clamped to [0, 1]) ->
    (N, n_levels * n_features), level-major."""
    n, nf = x.shape[0], spec.n_features
    res_f, res_m1, res_p1, first, rows, hashed, feat_ids = _level_tables(
        spec, x.device)
    flat = table.reshape(-1)
    x = torch.clamp(x, 0.0, 1.0)
    pos = x[:, None, :] * res_f[None, :, None]               # (N, L, D)
    i0 = torch.minimum(pos.to(torch.int64), res_m1[None, :, None])
    i0 = torch.clamp(i0, min=0)
    frac = pos - i0.to(pos.dtype)
    if spec.triplane:
        lin, w = _triplane_corners(i0, frac, res_p1)
    elif spec.dim == 3:
        lin, w = _volume_corners(i0, frac, res_p1, rows, hashed,
                                 any(spec.hashed))
    else:
        return _encode_2d(spec, flat, i0, frac, res_p1, first, rows, hashed,
                          feat_ids).reshape(n, spec.out_dim)
    # every corner of every level in one flat gather of its features
    corner = torch.take(flat, (first[:, None] + lin)[..., None] * nf
                        + feat_ids)                          # (N, L, C, F)
    feat = torch.sum(w[..., None] * corner, dim=2)
    return feat.reshape(n, spec.out_dim)


def _encode_2d(spec, flat, i0, frac, res_p1, first, rows, hashed, feat_ids):
    """The 2D levels, one gather a corner: (N, L, F)."""
    nf = spec.n_features
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
    return feat


# plane p of a tri-plane level reads axes _PLANE_U[p] and _PLANE_V[p]
_PLANE_U, _PLANE_V = (0, 0, 1), (1, 2, 2)


@functools.lru_cache(maxsize=8)
def _corner_tables(device: torch.device):
    """Corner constants on ``device``, made once a device: the planes'
    axes u (3,) and v (3,) and their ids (3, 1); a bilinear cell's corner
    offsets along u and v (4,); a trilinear cell's along x, y, z (8,)."""
    def t(v):
        return torch.tensor(v, device=device)

    return (t(_PLANE_U), t(_PLANE_V), t([[0], [1], [2]]), t([0, 0, 1, 1]),
            t([0, 1, 0, 1]), t([0, 0, 0, 0, 1, 1, 1, 1]),
            t([0, 0, 1, 1, 0, 0, 1, 1]), t([0, 1, 0, 1, 0, 1, 0, 1]))


def _weight(frac, corner):
    """Each corner's linear weight along one axis: frac where the corner
    is the cell's upper one, 1 - frac where it is the lower."""
    return torch.where(corner == 1, frac, 1.0 - frac)


def _triplane_corners(i0, frac, res_p1):
    """Rows within the level (N, L, 12) and weights (N, L, 12) of the
    three planes' four bilinear corners, plane-major."""
    pu, pv, plane, cu, cv = _corner_tables(i0.device)[:5]
    V = res_p1[None, :, None, None]
    iu, iv = i0[..., pu][..., None], i0[..., pv][..., None]   # (N, L, 3, 1)
    lin = plane * V * V + (iu + cu) * V + iv + cv            # (N, L, 3, 4)
    w = (_weight(frac[..., pu][..., None], cu)
         * _weight(frac[..., pv][..., None], cv))
    return lin.flatten(2), w.flatten(2)


def _volume_corners(i0, frac, res_p1, rows, hashed, any_hashed: bool):
    """Rows within the level (N, L, 8) and weights (N, L, 8) of the eight
    trilinear corners of a volumetric 3D level: dense (ix V + iy) V + iz,
    or on a hashed level ix ^ iy P1 ^ iz P2 (uint32 products) mod its
    rows (reference ``_grid_encode_gather``)."""
    cx, cy, cz = _corner_tables(i0.device)[5:]
    ix, iy, iz = (i0[..., d:d + 1] + c for d, c in enumerate((cx, cy, cz)))
    V = res_p1[None, :, None]
    lin = (ix * V + iy) * V + iz
    if any_hashed:
        h = (ix ^ ((iy * _HASH_PRIMES[1]) & _MASK32)
             ^ ((iz * _HASH_PRIMES[2]) & _MASK32))
        lin = torch.where(hashed[None, :, None], h % rows[None, :, None],
                          lin)
    w = (_weight(frac[..., 0:1], cx) * _weight(frac[..., 1:2], cy)
         * _weight(frac[..., 2:3], cz))
    return lin, w
