"""The sphere-selection plain versions against the JAX package's Pallas
kernels (pallas_sphere.sphere_select / sphere_select_full, interpret mode)
and its brute force (geometry.sphere_hit_all), on tests/test_pallas.py's
cases and on camera rays against the book cover's 485 spheres.

Criterion (tests/test_pallas.py's): the winner's index equal on every hit
lane; t and exit t within rtol=2e-4, atol=1e-3; the winner's record
exact; a block of rays with no active ray gets the miss sentinels.  One
measured exception: on the cover, a ray that grazes a small sphere's
silhouette has a discriminant within rounding of zero, and the JAX
kernel's float32 rounding can call it a hit where the brute force and the
port call it a miss (48x32, seed 2: 1 of 1296 hit lanes, float64
discriminant -1.1e-5).  So the index is held equal to the brute force's on
every hit lane and to the JAX kernel's on all but 0.1% of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import geometry as jax_geometry
from raytracing_in_one_weekend_tpu.ops import pallas_sphere
from raytracing_in_one_weekend_tpu_torch.ops import geometry, sphere_select

TOL = dict(rtol=2e-4, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts six test processes on the machine's cores: one
    torch thread each keeps the plain versions' ops from oversubscribing
    them (measured 26x slower for the cover golden with eight threads per
    process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_case(n=512, s=37, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = (rng.normal(size=(s, 3)) * 2).astype(np.float32)
    r = rng.uniform(0.4, 1.5, s).astype(np.float32)
    return o, d, c, r


def cover_case(w=48, h=32, seed=2):
    scene, cs = jax_scenes.cover_scene()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    rays = jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)
    return tuple(np.array(v, np.float32) for v in (
        rays.origin, rays.direction, scene.spheres.center,
        scene.spheres.radius))


CASES = {
    "random_512x37": lambda: random_case(512, 37, 0),
    "random_256x21": lambda: random_case(256, 21, 3),
    "cover_1536x485": cover_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sphere_select_matches_jax(case):
    o, d, c, r = CASES[case]()
    jt, ji, je = (np.asarray(v) for v in pallas_sphere.sphere_select(
        *map(jnp.asarray, (o, d, c, r)), interpret=True))
    t_all, exit_all = (np.asarray(v) for v in jax_geometry.sphere_hit_all(
        *map(jnp.asarray, (o, d)), jnp.zeros(o.shape[0]),
        *map(jnp.asarray, (c, r))))
    pt, pi, pe = (v.numpy() for v in sphere_select.sphere_select(
        *map(torch.tensor, (o, d, c, r))))
    assert pi.dtype == np.int32
    hit = t_all.min(axis=1) < 1e29
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(pt < 1e29, hit)
    np.testing.assert_array_equal(pi[hit], np.argmin(t_all, axis=1)[hit])
    np.testing.assert_allclose(pt[hit], t_all.min(axis=1)[hit], **TOL)
    np.testing.assert_allclose(
        pe[hit], np.take_along_axis(exit_all, pi[:, None].astype(int),
                                    1)[hit, 0], **TOL)
    assert (pt[~hit] == sphere_select.BIG).all()
    assert (pe[~hit] == sphere_select.BIG).all()
    # against the JAX kernel: silhouette roundings aside, the same
    same = pi == ji
    assert (~same).mean() <= (1e-3 if case.startswith("cover") else 0.0)
    both = same & hit
    np.testing.assert_allclose(pt[both], jt[both], **TOL)
    np.testing.assert_allclose(pe[both], je[both], **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sphere_select_full_matches_jax(case):
    o, d, c, r = CASES[case]()
    n, s = o.shape[0], c.shape[0]
    records = np.random.default_rng(1).normal(size=(s, 12)).astype(
        np.float32)
    jt, je, jn, jr = (np.asarray(v) for v in pallas_sphere.sphere_select_full(
        *map(jnp.asarray, (o, d, c, r, records)), want_exit=True,
        interpret=True))
    pt, pe, pn, pr = (v.numpy() for v in sphere_select.sphere_select_full(
        *map(torch.tensor, (o, d, c, r, records)), want_exit=True))
    # the winner's record, exactly (sphere 0's on a miss, as argmin's),
    # silhouette roundings of the JAX kernel aside (see above)
    same = (pr == jr).all(axis=1)
    assert (~same).mean() <= (1e-3 if case.startswith("cover") else 0.0)
    hit = (jt < 1e29) & same
    np.testing.assert_array_equal(pt[same] < 1e29, jt[same] < 1e29)
    np.testing.assert_allclose(pt[hit], jt[hit], **TOL)
    np.testing.assert_allclose(pe[hit], je[hit], **TOL)
    idx = np.argmin(np.asarray(jax_geometry.sphere_hit_all(
        *map(jnp.asarray, (o, d)), jnp.zeros(n),
        *map(jnp.asarray, (c, r)))[0]), axis=1)
    np.testing.assert_array_equal(pr[hit & same, :12],
                                  records[idx[hit & same]])
    # the normal is read off t, which on the cover cancels ~12 bits (its
    # r = 0.2 spheres seen from 13 units, tests/test_torch_megatrace.py):
    # measured within 6.1e-3 there, 1e-5 on the random cases
    n_tol = 1e-2 if case.startswith("cover") else 1e-3
    np.testing.assert_allclose(pn[hit & same], jn[hit & same], rtol=n_tol,
                               atol=n_tol)
    np.testing.assert_allclose(np.linalg.norm(pn[hit], axis=-1), 1.0,
                               atol=1e-2)
    # without want_exit every exit is the sentinel
    _, pe0, _, _ = sphere_select.sphere_select_full(
        *map(torch.tensor, (o, d, c, r, records)))
    assert (pe0.numpy() == sphere_select.BIG).all()


def test_inactive_blocks_write_miss_sentinels():
    o, d, c, r = random_case(n=1024, s=5, seed=7)
    records = np.ones((5, 12), np.float32)
    active = np.zeros(1024, bool)
    jt, _, _, jr = pallas_sphere.sphere_select_full(
        *map(jnp.asarray, (o, d, c, r, records)),
        active=jnp.asarray(active), interpret=True)
    pt, pe, _, pr = sphere_select.sphere_select_full(
        *map(torch.tensor, (o, d, c, r, records)),
        active=torch.tensor(active))
    assert (pt.numpy() >= sphere_select.BIG).all()
    assert (pe.numpy() >= sphere_select.BIG).all()
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    # one active ray keeps its block of BLOCK rays live, and only it
    active[300] = True
    pt, _, _, pr = sphere_select.sphere_select_full(
        *map(torch.tensor, (o, d, c, r, records)),
        active=torch.tensor(active))
    b0 = 300 // sphere_select.BLOCK * sphere_select.BLOCK
    live = np.zeros(1024, bool)
    live[b0:b0 + sphere_select.BLOCK] = True
    full_t, _, _, _ = sphere_select.sphere_select_full(
        *map(torch.tensor, (o, d, c, r, records)))
    np.testing.assert_array_equal(pt.numpy()[live], full_t.numpy()[live])
    assert (pt.numpy()[~live] >= sphere_select.BIG).all()


def test_geometry_matches_jax():
    o, d, c, r = random_case(256, 21, 5)
    jt, je = (np.asarray(v) for v in jax_geometry.sphere_hit_all(
        *map(jnp.asarray, (o, d)), jnp.zeros(256),
        *map(jnp.asarray, (c, r))))
    pt, pe = (v.numpy() for v in geometry.sphere_hit_all(
        *map(torch.tensor, (o, d, c, r))))
    np.testing.assert_allclose(pt, jt, **TOL)
    np.testing.assert_allclose(pe, je, **TOL)
    idx = np.argmin(jt, axis=1)
    st, se = (np.asarray(v) for v in jax_geometry.sphere_hit_single(
        *map(jnp.asarray, (o, d, c[idx], r[idx]))))
    qt, qe = (v.numpy() for v in geometry.sphere_hit_single(
        *map(torch.tensor, (o, d, c[idx], r[idx]))))
    np.testing.assert_allclose(qt, st, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qe, se, rtol=1e-5, atol=1e-5)
    p = o + qt.clip(max=10)[:, None] * d
    np.testing.assert_allclose(
        geometry.sphere_normal_at(torch.tensor(p), torch.tensor(c[idx]),
                                  torch.tensor(r[idx])).numpy(),
        np.asarray(jax_geometry.sphere_normal_at(p, c[idx], r[idx])),
        rtol=1e-6, atol=1e-6)


def test_selection_is_detached_and_the_winner_carries_gradients():
    o, d, c, r = (torch.tensor(v) for v in random_case(64, 7, 9))
    c = c.clone().requires_grad_()
    t, idx, _ = sphere_select.sphere_select(o, d, c, r)
    assert not t.requires_grad
    ts, _ = geometry.sphere_hit_single(o, d, c[idx.long()], r[idx.long()])
    hit = t < sphere_select.BIG
    torch.testing.assert_close(ts.detach()[hit], t[hit], rtol=2e-4,
                               atol=1e-3)
    ts[hit].sum().backward()
    assert bool(torch.isfinite(c.grad).all()) and float(c.grad.abs().max()) > 0


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from raytracing_in_one_weekend_tpu_torch.core import camera, rng
    from raytracing_in_one_weekend_tpu_torch.models import book_scenes

    dev = torch.device("cuda")
    scene, cs = book_scenes.cover_scene()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.5, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    key = rng.PRNGKey(2)
    rays = camera.generate_rays(cam, camera.pixel_coords(48, 32, key, True),
                                key)
    cases = {name: CASES[name] for name in CASES if name != "cover_1536x485"}
    cases["cover_1536x485"] = lambda: (
        rays.origin.numpy(), rays.direction.numpy(),
        scene.spheres.center.numpy(), scene.spheres.radius.numpy())
    for case in sorted(cases):
        o, d, c, r = (torch.tensor(v, device=dev) for v in cases[case]())
        n, s = o.shape[0], c.shape[0]
        rec = torch.randn((s, 12), generator=torch.Generator().manual_seed(
            1)).to(dev)
        active = torch.arange(n, device=dev) % 3 != 0
        active[:128] = False
        before = dict(sphere_select.LAUNCHES)
        got = sphere_select.sphere_select(o, d, c, r)
        want = sphere_select.sphere_select_reference(o, d, c, r)
        for g, w in zip(got, want):
            assert torch.equal(g, w), case
        got = sphere_select.sphere_select_full(o, d, c, r, rec,
                                               active=active, want_exit=True)
        want = sphere_select.sphere_select_full_reference(
            o, d, c, r, rec, active=active, want_exit=True)
        for g, w in zip((got[0], got[1], got[3]), want):
            assert torch.equal(g, w), case
        assert sphere_select.LAUNCHES["sphere_select"] == (
            before["sphere_select"] + 1)
        assert sphere_select.LAUNCHES["sphere_select_full"] == (
            before["sphere_select_full"] + 1)
