"""The triangle-selection kernel's plain version against the JAX kernel.

JAX side: ops/pallas_triangle.triangle_select(interpret=True), the Pallas
kernel run in interpret mode on the CPU.  Port side:
ops/triangle_select.triangle_select on CPU tensors, the plain version.
Three cases: random rays against random triangles (with an active mask
that leaves whole 256-ray tiles inactive), `mesh_showcase` camera rays,
and one bounce of those rays (cosine directions from the hit points).

Criterion: t within 1e-5 (relative, absolute below 1) on every lane, the
miss sentinel (1e30, 0) on the same lanes, and the same winner row on
every hit lane where the JAX package's brute force
(`geometry.triangle_hit_all`, argmin) picks the kernel's row too (a tie
within rounding may go either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.ops import geometry as jax_geometry
from raytracing_in_one_weekend_tpu.ops import pallas_triangle
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import triangle_select as ts

T_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_case(n=1536, t=300, seed=0):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-2, 2, (t, 3)).astype(np.float32)
    ea = r.normal(0, 0.6, (t, 3)).astype(np.float32)
    eb = r.normal(0, 0.6, (t, 3)).astype(np.float32)
    ea[:5] = 0.0  # degenerate rows: det == 0, never hit
    origin = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = r.random(n) < 0.7
    active[256:768] = False  # two whole tiles without an active ray
    return origin, d, ea, eb, v0, active


def showcase_case(bounce: bool):
    from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes

    scene, cs = jax_meshes.mesh_showcase()
    w, h = 40, 32
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(3)
    rays = jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)
    tri = scene.triangles
    origin = np.asarray(rays.origin)
    d = np.asarray(rays.direction)
    if bounce:
        t, idx = pallas_triangle.triangle_select(
            rays.origin, rays.direction, tri.edge_a, tri.edge_b, tri.vert0,
            interpret=True)
        t, idx = np.asarray(t), np.asarray(idx)
        hit = t < 1e29
        normal = np.cross(np.asarray(tri.edge_b)[idx],
                          np.asarray(tri.edge_a)[idx])
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        normal *= -np.sign((normal * d).sum(1, keepdims=True))
        r = np.random.default_rng(4)
        rd = r.normal(size=d.shape) + normal
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        origin = np.where(hit[:, None], origin + t[:, None] * d
                          + 1e-3 * normal, origin).astype(np.float32)
        d = np.where(hit[:, None], rd, d).astype(np.float32)
        active = hit
    else:
        active = np.ones(w * h, bool)
    return tuple(np.array(a) for a in (origin, d, tri.edge_a, tri.edge_b,
                                       tri.vert0, active))


CASES = {"random": lambda: random_case(),
         "showcase_camera": lambda: showcase_case(False),
         "showcase_bounce": lambda: showcase_case(True)}


@pytest.fixture(scope="module")
def jax_results():
    """Each case's inputs and the JAX kernel's (t, idx) and brute-force
    argmin, computed once for the module."""
    out = {}
    for name, make in CASES.items():
        origin, d, ea, eb, v0, active = make()
        t, idx = pallas_triangle.triangle_select(
            jnp.asarray(origin), jnp.asarray(d), jnp.asarray(ea),
            jnp.asarray(eb), jnp.asarray(v0), jnp.asarray(active),
            interpret=True)
        z = np.zeros((ea.shape[0], 3, 3), np.float32)
        t_all, _, _ = jax_geometry.triangle_hit_all(
            jnp.asarray(origin), jnp.asarray(d), jnp.asarray(ea),
            jnp.asarray(eb), jnp.asarray(v0), jnp.asarray(z),
            jnp.asarray(z[:, :2]), 0.0)
        brute = np.asarray(jnp.argmin(t_all, axis=1))
        out[name] = ((origin, d, ea, eb, v0, active), np.asarray(t),
                     np.asarray(idx), brute)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(jax_results, case):
    (origin, d, ea, eb, v0, active), want_t, want_idx, brute = \
        jax_results[case]
    before = ts.LAUNCHES
    got_t, got_idx = ts.triangle_select(
        *(torch.from_numpy(a) for a in (origin, d, ea, eb, v0)),
        torch.from_numpy(active))
    assert ts.LAUNCHES == before  # CPU tensors: the plain version
    got_t, got_idx = got_t.numpy(), got_idx.numpy()
    assert got_idx.dtype == np.int32
    hit = want_t < 1e29
    assert hit.mean() > 0.02, case  # bounced rays mostly leave
    np.testing.assert_array_equal(got_t >= 1e29, ~hit)
    np.testing.assert_array_equal(got_idx[~hit], want_idx[~hit])
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=T_TOL,
                               atol=T_TOL)
    sure = hit & (brute == want_idx)
    assert sure.mean() >= 0.99 * hit.mean()
    np.testing.assert_array_equal(got_idx[sure], want_idx[sure])


def test_inactive_tiles_write_the_miss_sentinel():
    origin, d, ea, eb, v0, active = random_case(n=1024, t=200, seed=2)
    args = [torch.from_numpy(a) for a in (origin, d, ea, eb, v0)]
    t, idx = ts.triangle_select(*args, torch.from_numpy(active))
    full_t, full_idx = ts.triangle_select(*args)
    dead = slice(256, 768)
    assert bool((t[dead] == 1e30).all()) and bool((idx[dead] == 0).all())
    live = torch.ones(1024, dtype=torch.bool)
    live[dead] = False
    # inactive rays of a live tile are swept like the others
    assert torch.equal(t[live], full_t[live])
    assert torch.equal(idx[live], full_idx[live])
    chunked = ts.triangle_select_reference(*args, torch.from_numpy(active),
                                           chunk_rays=300)
    assert torch.equal(chunked[0], t) and torch.equal(chunked[1], idx)


def test_fits_vmem_is_the_jax_rule():
    for count in (0, 1, 908, 4096, 4097, 5000):
        assert ts.fits_vmem(count) == pallas_triangle.fits_vmem(count)
    assert ts.RAY_TILE == pallas_triangle.RAY_TILE
    assert ts.MAX_TRI_PAD == pallas_triangle.MAX_TRI_PAD
    scene, _ = meshes.mesh_showcase()
    assert ts.fits_vmem(scene.triangles.vert0.shape[0])


def test_other_devices_are_refused():
    meta = [torch.zeros((4, 3), device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="unsupported device"):
        ts.triangle_select(*meta)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    origin, d, ea, eb, v0, active = random_case(n=4096, t=1000, seed=7)
    args = [torch.from_numpy(a).cuda() for a in (origin, d, ea, eb, v0)]
    act = torch.from_numpy(active).cuda()
    before = ts.LAUNCHES
    got = ts.triangle_select(*args, act)
    assert ts.LAUNCHES == before + 1
    want = ts.triangle_select_reference(*args, act)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
