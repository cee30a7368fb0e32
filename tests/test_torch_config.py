"""fresco_torch.core.config against fresco_tpu.core.config: both parse the
repo's config files to equal fields (exact: no arithmetic involved)."""
import dataclasses
import pathlib

import pytest

from fresco_torch.core import config as tc
from fresco_tpu.core import config as jc

CONFIGS = sorted(pathlib.Path(__file__).resolve().parents[1].glob("config/*.yaml"))


def test_four_configs_present():
    assert len(CONFIGS) == 4


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_configs_parse_equal(path):
    a = dataclasses.asdict(jc.load_config(str(path)))
    b = dataclasses.asdict(tc.load_config(str(path)))
    assert a == b


def test_schema_and_helpers_equal():
    assert [f.name for f in dataclasses.fields(jc.FrescoConfig)] == \
        [f.name for f in dataclasses.fields(tc.FrescoConfig)]
    assert dataclasses.asdict(jc.FrescoConfig()) == dataclasses.asdict(tc.FrescoConfig())
    for sd in ("runwayml/stable-diffusion-v1-5", "SG161222/Realistic_Vision"):
        assert jc.default_prompts(sd) == tc.default_prompts(sd)
    for keys, bs in (([0, 3, 7, 9, 12, 20, 22, 30, 31, 40, 41], 8), (list(range(5)), 4),
                     (list(range(23)), 8)):
        assert jc.keyframe_sublists(keys, bs) == tc.keyframe_sublists(keys, bs)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 4), (2, 2)])
def test_a_device_mesh_raises_until_parallel_is_ported(mesh):
    """The JAX pipeline shards over a mesh when prod(mesh_shape) > 1; the
    port says it cannot, before it builds a model."""
    from fresco_torch.pipeline.runner import FrescoPipeline

    with pytest.raises(NotImplementedError, match="parallel/"):
        FrescoPipeline(tc.FrescoConfig(mesh_shape=mesh), tiny=True, device="cpu")
