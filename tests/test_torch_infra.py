"""The host side of ash_tpu_torch: deletion queue, resource registry, pools,
frame graph, safe resource, auto-rotation, resize, and the scene systems'
host state (tests/test_infra.py's and tests/test_scene_systems.py's cases
on the port, with values held to ash_tpu's where they are values).

Not here: ash_tpu's pipeline cache and live-program registry, which cache
XLA programs (ROADMAP.md "Not ported").
"""

import threading
import uuid

import numpy as np
import pytest
import torch

from ash_tpu.render import csm as ref_csm
from ash_tpu.render import lod_system as ref_lod
from ash_tpu_torch import Camera, Mesh
from ash_tpu_torch.core import maths
from ash_tpu_torch.core.transform import Transform
from ash_tpu_torch.render import HeadlessSurface, Renderer, RendererConfig
from ash_tpu_torch.render.csm import MAX_CASCADES, CascadedShadowMap, CsmConfig
from ash_tpu_torch.render.deletion_queue import DeletionQueue
from ash_tpu_torch.render.features import AutoRotateFeature, FeatureFrameContext
from ash_tpu_torch.render.frame_graph import FrameGraph, PassDescription
from ash_tpu_torch.render.instancing import InstanceData, InstancingManager
from ash_tpu_torch.render.lod_system import (
    LodConfig,
    LodLevel,
    LodManager,
    LodMesh,
    screen_coverage,
    screen_coverage_batch,
)
from ash_tpu_torch.render.occlusion_culling import (
    CullBoundingBox,
    CullObjectData,
    OcclusionCullingSystem,
)
from ash_tpu_torch.render.pools import (
    BufferPool,
    OptimizedBufferPool,
    ThreadSafeResourcePool,
)
from ash_tpu_torch.render.resource_registry import (
    RegistryError,
    ResourceRegistry,
    ResourceType,
)
from ash_tpu_torch.render.safe_resource import SafeResource

torch.set_num_threads(1)


# -- deletion queue ----------------------------------------------------------

def test_deletion_queue_lifo_order():
    order = []
    q = DeletionQueue()
    for i in range(5):
        q.push(lambda i=i: order.append(i))
    assert q.flush() == 5
    assert order == [4, 3, 2, 1, 0]
    assert len(q) == 0


def test_deletion_queue_threaded_push():
    q = DeletionQueue()
    done = []

    def worker():
        for _ in range(20):
            q.push(lambda: done.append(1))

    threads = [threading.Thread(target=worker) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert q.flush() == 200 and len(done) == 200


def test_deletion_queue_logs_a_failed_release_and_goes_on(caplog):
    q = DeletionQueue()
    ran = []
    q.push(lambda: ran.append(1))
    q.push(lambda: 1 / 0)
    assert q.flush() == 2
    assert ran == [1]
    assert any("deferred delete failed" in m for m in caplog.messages)


def test_deletion_queue_holds_a_tensor_until_the_flush():
    import weakref

    q = DeletionQueue()
    t = torch.ones(16)
    ref = weakref.ref(t)
    q.push_array(t)
    del t
    assert ref() is not None
    q.flush()
    assert ref() is None


# -- registry ----------------------------------------------------------------

def test_registry_dependency_cleanup_order():
    reg = ResourceRegistry()
    order = []
    rp = reg.register_render_pass("rp", destroy=lambda: order.append("rp"))
    reg.register_framebuffer("fb", destroy=lambda: order.append("fb"),
                             deps=[rp])
    assert reg.cleanup() == 2
    assert order == ["fb", "rp"]
    assert reg.cleanup() == 0


def test_registry_remove_guard():
    reg = ResourceRegistry()
    rp = reg.register_render_pass("rp")
    reg.register_framebuffer("fb", deps=[rp])
    with pytest.raises(RegistryError):
        reg.remove(rp)
    assert len(reg) == 2
    reg.remove(rp, force=True)
    assert len(reg) == 1


def test_registry_unknown_dependency():
    reg = ResourceRegistry()
    with pytest.raises(RegistryError):
        reg.register(ResourceType.PIPELINE, "p", None, [uuid.uuid4()])


def test_registry_poison_tolerant():
    reg = ResourceRegistry()
    ran = []
    reg.register_pipeline("bad", destroy=lambda: 1 / 0)
    reg.register_pipeline("good", destroy=lambda: ran.append(1))
    assert reg.cleanup() == 2
    assert ran == [1]


def test_registry_device_array_dropped_on_cleanup():
    import weakref

    reg = ResourceRegistry()
    t = torch.ones(4)
    ref = weakref.ref(t)
    reg.register_device_array("t", t)
    del t
    assert ref() is not None
    reg.cleanup()
    assert ref() is None


# -- pools -------------------------------------------------------------------

def test_buffer_pool_first_fit_and_stats():
    pool = BufferPool()
    a = pool.acquire(100)
    pool.acquire(500)
    assert pool.stats() == (0, 2, 600)
    pool.release(a)
    assert pool.stats() == (1, 1, 600)
    assert pool.acquire(50) is a
    assert pool.stats() == (0, 2, 600)


def test_optimized_pool_size_classes():
    assert OptimizedBufferPool.size_class(1) == 256
    assert OptimizedBufferPool.size_class(256) == 256
    assert OptimizedBufferPool.size_class(257) == 512
    assert OptimizedBufferPool.size_class(64 * 2**20) == 64 * 2**20
    with pytest.raises(ValueError):
        OptimizedBufferPool.size_class(65 * 2**20)
    pool = OptimizedBufferPool()
    x = pool.acquire(300)
    assert x.size == 512
    pool.release(x)
    assert pool.acquire(400) is x
    st = pool.stats[512]
    assert st.allocations == 1 and st.reuses == 1


def test_thread_safe_pool_hit_miss_and_guard():
    made = []
    pool = ThreadSafeResourcePool(lambda: made.append(1) or object())
    with pool.acquire() as r1:
        pass
    with pool.acquire() as r2:
        assert r2 is r1
    assert pool.stats.misses == 1 and pool.stats.hits == 1
    assert pool.stats.hit_rate == 0.5


# -- frame graph, safe resource ----------------------------------------------

def test_frame_graph_execute():
    g = FrameGraph()
    g.add_pass(PassDescription(name="double", run=lambda i: {"y": i["x"] * 2},
                               reads=["x"], writes=["y"]))
    g.add_pass(PassDescription(name="inc", run=lambda i: {"z": i["y"] + 1},
                               reads=["y"], writes=["z"]))
    assert g.execute({"x": 10})["z"] == 21
    g.get("inc").enabled = False
    assert "z" not in g.execute({"x": 1})
    with pytest.raises(ValueError):
        g.add_pass(PassDescription(name="double", run=lambda i: {}))


def test_frame_graph_missing_input():
    g = FrameGraph()
    g.add_pass(PassDescription(name="p", run=lambda i: {}, reads=["nope"]))
    with pytest.raises(KeyError):
        g.execute({})


def test_safe_resource():
    cleaned = []
    with SafeResource(42, cleaned.append) as v:
        assert v == 42
    assert cleaned == [42]
    r = SafeResource("x", cleaned.append)
    assert r.release() == "x"
    r.close()
    assert cleaned == [42]


# -- auto-rotation, resize ---------------------------------------------------

def test_auto_rotate_feature_spins_the_transform():
    t = Transform.identity()
    feat = AutoRotateFeature(speed=(0.0, 2.0, 0.0))
    feat.before_frame(FeatureFrameContext(delta_time=0.5, transform=t))
    np.testing.assert_array_equal(t.model_matrix(), np.eye(4))
    feat.before_frame(FeatureFrameContext(delta_time=0.5, auto_rotate=True,
                                          transform=t))
    m = t.model_matrix()
    np.testing.assert_allclose(m[0, 0], np.cos(1.0), atol=1e-6)


def _cube_renderer(w=32, h=24):
    r = Renderer(HeadlessSurface(w, h), RendererConfig(
        tile_h=8, tile_w=32, max_tris_per_tile=32, shadow_resolution=64,
        shadow_tile=64), device="cpu")
    r.set_mesh(Mesh.create_cube())
    cam = Camera.new([3.0, 2.0, 4.0], [0, 0, 0], w / h)
    return r, (cam.view_matrix(), cam.projection_matrix(), cam.position)


def test_renderer_auto_rotate_moves_the_single_mesh():
    """As in the reference, the hooks run after the frame read the draw
    items: a rotation step shows in the frame after it."""
    r, cam = _cube_renderer()
    r.render_frame(*cam)
    still = r.read_back().copy()
    r.auto_rotate = True
    r._last_frame_time -= 0.5  # half a second since the last frame
    r.render_frame(*cam)
    np.testing.assert_array_equal(r.read_back(), still)
    assert not np.allclose(r.transform.model_matrix(), np.eye(4))
    r.render_frame(*cam)
    assert not np.array_equal(r.read_back(), still)


def test_request_swapchain_resize_is_adopted_next_frame():
    """The pending extent renders the next frame, whose TAA history and
    previous depth start over; the frame after follows the surface."""
    r, cam = _cube_renderer()
    r.initialize_hdr()
    r.set_taa_enabled(True)
    r.set_occlusion_culling(True)
    r.render_frame(*cam)
    assert r._taa_history is not None and r._prev_depth is not None
    r.request_swapchain_resize(40, 20)
    assert r.wait_resize() is True and r.wait_resize(timeout=0.1) is True
    history = r._taa_history
    out = r.render_frame(*cam)
    assert out.image.shape == (20, 40, 4) and out.depth.shape == (20, 40)
    assert r._taa_history is not history
    assert r._taa_history.shape == (20, 40, 3)
    assert r.render_frame(*cam).image.shape == (24, 32, 4)


# -- scene systems' host state -----------------------------------------------

def _vp():
    view = maths.look_at_rh([0, 0, 10], [0, 0, 0], [0, 1, 0])
    proj = maths.perspective_rh(np.deg2rad(45), 1.0, 0.1, 100.0)
    return proj @ view


def test_csm_splits_and_update_equal_the_reference():
    csm, ref = CascadedShadowMap(CsmConfig()), ref_csm.CascadedShadowMap(
        ref_csm.CsmConfig())
    splits = csm.calculate_splits(0.1, 100.0)
    np.testing.assert_array_equal(splits, ref.calculate_splits(0.1, 100.0))
    assert splits[0] == np.float32(0.1)
    assert splits[1] < splits[2] < splits[3] < splits[4] <= 100.0
    view = maths.look_at_rh([0, 5, 10], [0, 0, 0], [0, 1, 0])
    proj = maths.perspective_rh(np.deg2rad(45), 16 / 9, 0.1, 100.0)
    light = np.array([-0.5, -1.0, -0.3]) / np.linalg.norm([-0.5, -1, -0.3])
    csm.update(view, proj, light, 50.0)
    ref.update(view, proj, light, 50.0)
    gpu, ref_gpu = csm.gpu_data(), ref.gpu_data()
    assert gpu.params[0] == 4.0
    assert gpu.light_matrices.shape == (MAX_CASCADES, 4, 4)
    np.testing.assert_array_equal(gpu.light_matrices, ref_gpu.light_matrices)
    assert np.all(np.diff(gpu.split_distances) > 0)
    assert CsmConfig.high_quality().resolution == 4096
    assert CsmConfig.performance().cascade_count == 2


def test_screen_coverage_equals_the_reference():
    vp = _vp()
    near = screen_coverage([0, 0, 5], 1.0, vp, 1920, 1080)
    far = screen_coverage([0, 0, -50], 1.0, vp, 1920, 1080)
    assert near > far > 0
    assert screen_coverage([0, 0, 20], 1.0, vp, 1920, 1080) == 0.0
    assert near == ref_lod.screen_coverage([0, 0, 5], 1.0, vp, 1920, 1080)
    pos = np.array([[0, 0, 5], [0, 0, 0], [3, 1, -20]], np.float32)
    radii = np.array([1.0, 2.0, 0.5], np.float32)
    batch = screen_coverage_batch(pos, radii, vp, 640, 480)
    np.testing.assert_array_equal(
        batch, ref_lod.screen_coverage_batch(pos, radii, vp, 640, 480))
    for i in range(3):
        np.testing.assert_allclose(
            batch[i], screen_coverage(pos[i], float(radii[i]), vp, 640, 480),
            rtol=1e-5)


def test_lod_selection_reduction_and_cull():
    mgr = LodManager(LodConfig(smooth_transitions=False))
    mesh = LodMesh(name="m", levels=[
        LodLevel(screen_threshold=0.1, triangle_count=1000),
        LodLevel(screen_threshold=0.01, triangle_count=250),
        LodLevel(screen_threshold=0.0, triangle_count=60)])
    vp = _vp()
    near = mgr.select_lod(mesh, [0, 0, 8], vp, [0, 0, 10], 800, 600)
    far = mgr.select_lod(mesh, [0, 0, -10], vp, [0, 0, 10], 800, 600)
    assert near.level < far.level and not near.culled
    assert mgr.stats.triangles_before == 2000
    assert 0.0 < mgr.stats.reduction_rate < 1.0
    mgr = LodManager()
    one = LodMesh("m", [LodLevel(screen_threshold=0.0, triangle_count=10)])
    sel = mgr.select_lod(one, [0, 0, -4000], vp, [0, 0, 10], 800, 600)
    assert sel.culled and mgr.stats.objects_culled == 1


def test_instancing_batches_and_layout():
    mgr = InstancingManager()
    m = np.eye(4, dtype=np.float32)
    assert mgr.add_instance(1, 1, InstanceData(model=m))
    assert mgr.add_instance(1, 1, InstanceData(
        model=maths.mat4_translation([5, 0, 0])))
    assert mgr.add_instance(2, 1, InstanceData(model=m))
    stats = mgr.stats()
    assert (stats.total_instances, stats.batch_count,
            stats.draw_calls_saved) == (3, 2, 1)
    batch = mgr.batches[(1, 1)]
    assert batch.packed().shape == (2, 24)
    np.testing.assert_allclose(batch.bounds_max, [5, 0, 0])
    flat = InstanceData(model=maths.mat4_translation([1, 2, 3])).flat()
    assert flat.shape == (24,)
    assert flat[3] == 1.0 and flat[7] == 2.0 and flat[11] == 3.0


def test_occlusion_host_state():
    bb = CullBoundingBox.from_min_max([-1, -2, -3], [1, 2, 3])
    np.testing.assert_allclose(bb.center, [0, 0, 0])
    np.testing.assert_allclose(bb.extents, [1, 2, 3])
    assert bb.corners().shape == (8, 3)
    np.testing.assert_allclose(bb.corners().min(0), [-1, -2, -3])
    occ = OcclusionCullingSystem()
    for i in range(3):
        occ.register(CullObjectData(
            bounds=CullBoundingBox.from_min_max([-1, -1, -1], [1, 1, 1]),
            model=maths.mat4_translation([i * 3.0, 0, 0]), draw_index=i))
    c, e, m, en = occ.packed()
    assert c.shape == (3, 3) and m.shape == (3, 4, 4) and en.all()
    stats = occ.record_result(np.array([1, 0, 1]))
    assert stats.visible == 2
    assert abs(stats.culled_fraction - 1 / 3) < 1e-6
