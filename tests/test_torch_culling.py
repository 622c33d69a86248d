"""Frustum culling and stream compaction: ash_tpu_torch.ops.occlusion and
ops.compute_utils against ash_tpu on the same numpy inputs (Hi-Z culling:
tests/test_torch_hiz.py).

Visibility flags, draw lists and counts are exact; planes and world bounds
atol 1e-5 (f32 sums in another order than XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ash_tpu.core.transform import Camera
from ash_tpu.ops import compute_utils as ref_cu
from ash_tpu.ops import occlusion as ref_occ
from ash_tpu_torch.ops import compute_utils, hiz, occlusion

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("capacity", [5, 40, 64])
def test_prefix_sum_compact_matches_reference(capacity):
    mask = np.random.default_rng(capacity).random(64) > 0.6
    ref_idx, ref_n = ref_cu.prefix_sum_compact(jnp.asarray(mask), capacity)
    idx, n = compute_utils.prefix_sum_compact(_t(mask), capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert int(n) == int(ref_n)


def _draws(n=200, seed=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    extents = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    models[:, :3, :3] *= rng.uniform(0.5, 2.0, (n, 1, 1)).astype(np.float32)
    models[:, :3, 3] = rng.uniform(-30, 30, (n, 3))
    enabled = rng.random(n) > 0.05
    cam = Camera.new([0.0, 5.0, 20.0], [0, 0, 0], 16 / 9)
    vp = (cam.projection_matrix() @ cam.view_matrix()).astype(np.float32)
    return centers, extents, models, enabled, vp


def test_frustum_planes_and_world_bounds_match_reference():
    centers, extents, models, _, vp = _draws()
    np.testing.assert_allclose(
        compute_utils.extract_frustum_planes(_t(vp)).numpy(),
        np.asarray(ref_cu.extract_frustum_planes(jnp.asarray(vp))),
        atol=1e-5, rtol=0,
    )
    got = occlusion.world_bounds(_t(centers), _t(extents), _t(models))
    ref = ref_occ.world_bounds(jnp.asarray(centers), jnp.asarray(extents),
                               jnp.asarray(models))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_cull_objects_matches_reference():
    centers, extents, models, enabled, vp = _draws()
    ref = ref_occ.cull_objects(
        jnp.asarray(centers), jnp.asarray(extents), jnp.asarray(models),
        jnp.asarray(enabled), jnp.asarray(vp), None, 64, 36,
    )
    got = occlusion.cull_objects(_t(centers), _t(extents), _t(models),
                                 _t(enabled), _t(vp))
    np.testing.assert_array_equal(got.visibility.numpy(), np.asarray(ref.visibility))
    np.testing.assert_array_equal(got.draw_list.numpy(), np.asarray(ref.draw_list))
    assert int(got.visible_count) == int(ref.visible_count)
    assert 0 < int(got.visible_count) < len(enabled)  # some culled, some kept


def test_hiz_occlusion_is_unported():
    """Named for the refusal this test held before Hi-Z was ported; it now
    checks that a pyramid without the depth buffer's size is refused
    (tests/test_torch_hiz.py holds the Hi-Z cull to the reference)."""
    centers, extents, models, enabled, vp = _draws(4)
    with pytest.raises(ValueError, match="size"):
        occlusion.cull_objects(_t(centers), _t(extents), _t(models),
                               _t(enabled), _t(vp),
                               pyr=hiz.build_hiz(torch.ones(8, 8)))
