"""One dispatch point for the dense matcher (pallas_cost_volume.use_kernel):
the kernel only where it compiles, no silent interpreter fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.config import MatcherConfig
from stereo_reconstruction.ops.block_search import block_search_right
from stereo_reconstruction.ops.pallas_cost_volume import use_kernel
from stereo_reconstruction.parallel import make_mesh, sharded_block_search_right


def test_auto_on_cpu_takes_the_xla_path():
    assert jax.default_backend() == "cpu"
    assert use_kernel(MatcherConfig(backend="auto")) is False
    assert use_kernel(MatcherConfig(backend="auto"), interpret=True) is False
    assert use_kernel(MatcherConfig(backend="xla"), interpret=True) is False


def test_auto_on_gpu_takes_the_kernel_where_it_covers(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert use_kernel(MatcherConfig(backend="auto")) is True
    assert use_kernel(MatcherConfig(backend="auto", cost="ncc")) is False
    assert use_kernel(MatcherConfig(backend="auto", min_disparity=-4)) is False
    assert use_kernel(MatcherConfig(backend="auto", var_block=True)) is False
    assert use_kernel(MatcherConfig(backend="pallas")) is True


def test_pallas_on_cpu_raises_instead_of_interpreting():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        use_kernel(MatcherConfig(backend="pallas"))
    assert use_kernel(MatcherConfig(backend="pallas"), interpret=True) is True
    img = jnp.ones((24, 32, 3), jnp.float32)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        block_search_right(img, img, MatcherConfig(backend="pallas",
                                                   max_disparity=8))


@pytest.mark.parametrize("kw", [dict(cost="sad"), dict(min_disparity=-2),
                                dict(var_block=True)])
def test_pallas_on_uncovered_config_raises(kw):
    with pytest.raises(ValueError, match="covers"):
        use_kernel(MatcherConfig(backend="pallas", **kw), interpret=True)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown matcher backend"):
        use_kernel(MatcherConfig(backend="mosaic"))


def test_sharded_matcher_uses_the_same_dispatch():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    mesh = make_mesh(data=1, tile=2, devices=jax.devices()[:2])
    img = jnp.asarray(np.full((1, 48, 32, 3), 7.0, np.float32))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        sharded_block_search_right(
            img, img, mesh, MatcherConfig(backend="pallas", block_size=5,
                                          max_disparity=8), exact=True)
