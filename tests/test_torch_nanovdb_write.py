"""The port's NanoVDB writer (``elaina_tpu_torch/core/nanovdb.write_nvdb``)
against the JAX package's: the same bytes for the same inputs, with both
codecs, Float and Vec3f grids, and origins that are negative and that
straddle leaf, lower- and upper-node boundaries.  Both readers read the
port's file back exactly."""

import hashlib

import numpy as np
import pytest

from elaina_tpu.core import nanovdb as JN
from elaina_tpu_torch.core import nanovdb as TN

CASES = {
    "float_small": ((5, 4, 3), (0, 0, 0), 1.0, (0.0, 0.0, 0.0)),
    "float_negative": ((11, 9, 10), (-5, -13, -2), 0.25, (-1.0, 2.0, 0.5)),
    "vec3_lower_edge": ((9, 6, 12), (124, -132, 3), (0.5, 0.25, 2.0),
                        (0.0, -3.0, 1.0)),
    "vec3_upper_edge": ((6, 10, 5), (-4, 4092, -4099), 1.5,
                        (10.0, 0.0, -2.0)),
}


@pytest.mark.parametrize("codec", [TN.CODEC_NONE, TN.CODEC_ZIP])
@pytest.mark.parametrize("case", sorted(CASES))
def test_write_nvdb_matches_jax(tmp_path, case, codec):
    shape, origin, voxel, offset = CASES[case]
    rng = np.random.default_rng(len(case) + codec)
    vec = case.startswith("vec3")
    values = rng.normal(size=shape + ((3,) if vec else ())).astype(np.float32)
    values[rng.random(shape) < 0.2] = 0.0
    kw = dict(voxel_size=voxel, world_offset=offset, origin=origin,
              name=f"grid_{case}", codec=codec)
    jp, tp = tmp_path / "jax.nvdb", tmp_path / "port.nvdb"
    JN.write_nvdb(str(jp), values, **kw)
    TN.write_nvdb(str(tp), values, **kw)
    assert tp.read_bytes() == jp.read_bytes()

    for read in (JN.read_nvdb, TN.read_nvdb):
        g = read(str(tp))
        want = values if vec else values[..., None]
        np.testing.assert_array_equal(g.values, want)
        np.testing.assert_array_equal(g.origin, origin)
        np.testing.assert_array_equal(g.voxel_size,
                                      np.broadcast_to(voxel, (3,)))
        np.testing.assert_array_equal(g.world_offset, offset)
        assert g.name == f"grid_{case}"


def test_write_nvdb_is_deterministic(tmp_path):
    """Two writes of one array give one file (ZIP codec), and the default
    arguments are the JAX writer's."""
    values = np.random.default_rng(0).random((7, 8, 9)).astype(np.float32)
    digests = []
    for i in range(2):
        p = tmp_path / f"{i}.nvdb"
        TN.write_nvdb(str(p), values, codec=TN.CODEC_ZIP)
        digests.append(hashlib.md5(p.read_bytes()).hexdigest())
    assert digests[0] == digests[1]
    JN.write_nvdb(str(tmp_path / "j.nvdb"), values)
    TN.write_nvdb(str(tmp_path / "t.nvdb"), values)
    assert (tmp_path / "j.nvdb").read_bytes() == \
        (tmp_path / "t.nvdb").read_bytes()


def test_write_nvdb_rejects_blosc(tmp_path):
    with pytest.raises(ValueError):
        TN.write_nvdb(str(tmp_path / "b.nvdb"), np.zeros((2, 2, 2)), codec=2)
