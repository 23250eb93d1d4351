"""The bounce-synchronous sampler's near-to-far triangle sweep and its
gathering restore (ops/meshtrace.py), against the JAX package and the
plain versions.

* (a) `tile_super_order` at group = RAY_TILE against JAX's
  `_tile_super_order` on every bounce state of a recorded mesh_large and
  mesh_huge 32x32, 8-spp wave (depth 3): the visit orders equal wherever
  the keys differ, the distances within 1e-6 relative (+inf where JAX has
  it).
* (b) `sync_traversal`, the kernel's sweep step for step (group order,
  early stop, block vote, lexicographic tie), against
  megatrace._tri_stream_sweep, bit for bit: on those waves' lanes with the
  spheres' hits (winner flags equal, (t, row, u, v) equal where a triangle
  wins) and without spheres (equal on every live lane); on a soup whose
  blocks repeat in a later super (exact ties across supers, visited near
  to far and in reverse); and on rays aimed into the highest-index super.
* (c) The band: through `_compact_pass`'s schedule of _HALF_BAND passes,
  with lanes dying and turning, a lane's id and its column lie within
  (passes + 1) x RAY_TILE of each other; the inverse index then gather
  equals `restore_reference` bit for bit.
* (d) cuda-marked: the kernels against their plain versions (bounce_sync
  and restore, bit for bit), the visit order the kernel's blocks compute
  (read back) against tile_super_order's, and `restore` on corrupt
  lane-id rows, which must raise at the next synchronise (in a
  subprocess: the trap ends the CUDA context).  That any visit order
  gives the plain winner is (b)'s reverse-order case.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.ops import pallas_meshtrace
from raytracing_in_one_weekend_tpu_torch.core import camera, materials, rng
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace as mk
from raytracing_in_one_weekend_tpu_torch.ops import meshtrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE = dict(width=32, spp=8, depth=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def record_wave(name, dev):
    """(scene, stream, every bounce_sync call's (state, args, kwargs)) of
    one 8-spp wave of `name` at 32x32, depth 3, on `dev`."""
    scene, cs = getattr(meshes, name)()
    scene = scene.to(dev)
    w = WAVE["width"]
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance, device=dev)
    pk = materials.pack_materials(scene)
    stream = mk.pack_tri_stream_tables(scene, pk)
    calls = []
    inner = meshtrace.bounce_sync

    def recording(state, *args, **kwargs):
        calls.append((state.clone(), args, kwargs))
        return inner(state, *args, **kwargs)

    meshtrace.bounce_sync = recording
    try:
        meshtrace.sample_batch_sync(
            torch.full((w * w,), WAVE["spp"], dtype=torch.int32, device=dev),
            torch.zeros(w * w, device=dev), cam, rng.PRNGKey(5),
            scene.spheres.center, scene.spheres.radius,
            mk.pack_sphere_records(scene, pk), scene.environment.sky_bottom,
            scene.environment.sky_top, stream, width=w, height=w,
            samples=WAVE["spp"], trace_depth=WAVE["depth"],
            has_dielectrics=scene.flags.has_dielectrics)
    finally:
        meshtrace.bounce_sync = inner
    assert len(calls) == WAVE["depth"]
    return scene, stream, calls


@pytest.fixture(scope="module")
def waves():
    return {name: record_wave(name, torch.device("cpu"))
            for name in ("mesh_large", "mesh_huge")}


CASES = [(name, b) for name in ("mesh_large", "mesh_huge")
         for b in range(WAVE["depth"])]


# ---------------------------------------------------------------------------
# (a) the order against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,bounce", CASES)
def test_tile_super_order_matches_jax(waves, name, bounce):
    _, stream, calls = waves[name]
    state = calls[bounce][0]
    n_tiles = state.shape[1] // meshtrace.RAY_TILE
    n_sup = stream.sup.shape[0]
    # JAX's sup row: lo | hi | 0 0 per super
    sup_row = torch.cat([stream.sup[:, 0:3], stream.sup[:, 4:7],
                         torch.zeros(n_sup, 2)], dim=1).reshape(1, -1)
    want_order, want_dist = (np.asarray(x)[:, 0] for x in
                             pallas_meshtrace._tile_super_order(
                                 jnp.asarray(state.numpy()),
                                 jnp.asarray(sup_row.numpy()), n_tiles,
                                 n_sup))
    order, dist = meshtrace.tile_super_order(state, stream.sup,
                                             meshtrace.RAY_TILE)
    assert order.dtype == torch.int32 and dist.dtype == torch.float32
    assert order.shape == (n_tiles, n_sup) == want_order.shape
    order, dist = order.numpy(), dist.numpy()
    # each row a permutation, its keys ascending
    assert (np.sort(order, axis=1) == np.arange(n_sup)).all()
    assert (dist[:, 1:] >= dist[:, :-1]).all()
    assert (np.isinf(dist) == np.isinf(want_dist)).all()
    fin = np.isfinite(want_dist)
    np.testing.assert_allclose(dist[fin], want_dist[fin], rtol=1e-6, atol=0)
    assert fin.any()
    # the same super at each place, unless the keys there tie
    key = np.take_along_axis(dist, np.argsort(order, axis=1), axis=1)
    differ = order != want_order
    for t, k in zip(*np.nonzero(differ)):
        assert np.isclose(key[t, order[t, k]], key[t, want_order[t, k]],
                          rtol=1e-6, atol=0), (t, k)


# ---------------------------------------------------------------------------
# (b) the kernel's traversal against the plain sweep
# ---------------------------------------------------------------------------


def lane_rays(state):
    live = state[12] > 0.0
    return (tuple(state[i] for i in range(3)),
            tuple(state[i] for i in range(3, 6)), live)


def assert_same_hits(o, d, best_t, live, stream, order, dist, group,
                     all_lanes: bool):
    got, counts = meshtrace.sync_traversal(o, d, best_t, live, stream, group,
                                           order, dist)
    want = mk._tri_stream_sweep(tuple(x[live] for x in o),
                                tuple(x[live] for x in d), best_t[live],
                                stream, 0.0)
    got = [g[live] for g in got]
    wins = want[0] < best_t[live]
    np.testing.assert_array_equal((got[0] < best_t[live]).numpy(),
                                  wins.numpy())
    keep = torch.ones_like(wins) if all_lanes else wins
    assert bool(keep.any())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[keep].numpy(), w[keep].numpy())
    # a lane tests no more than the group stages, and no lane tests a
    # block twice
    assert counts["lane_pairs"] <= counts["warp_pairs"] \
        <= 32 * counts["group_pairs"]
    return got, counts


@pytest.mark.parametrize("name,bounce", CASES)
def test_traversal_matches_plain_sweep(waves, name, bounce):
    scene, stream, calls = waves[name]
    state, args, _ = calls[bounce]
    o, d, live = lane_rays(state)
    sph = args[3][0]
    best_t, _ = mk._sweep(o, d, sph, 0.0)
    group = meshtrace.SYNC_GROUP
    order, dist = meshtrace.tile_super_order(state, stream.sup, group)
    assert_same_hits(o, d, best_t, live, stream, order, dist, group, False)
    # without the spheres every live lane's nearest triangle is the same
    no_spheres = torch.full_like(best_t, mk.BIG)
    order, dist = meshtrace.tile_super_order(state, stream.sup, 256)
    assert_same_hits(o, d, no_spheres, live, stream, order, dist, 256, True)


def soup_stream(ea, eb, v0):
    """A TriStream of the given triangles, in this order (a whole number
    of supers), with pack_tri_stream_tables' boxes."""
    t = ea.shape[0]
    n_blk = t // mk.TRI_BLOCK
    n_sup = n_blk // mk.TRI_SUP
    assert n_sup * mk.TRI_SUP * mk.TRI_BLOCK == t
    geo = torch.zeros((t, 12))
    geo[:, 0:3], geo[:, 3:6], geo[:, 6:9] = ea, eb, v0
    v1, v2 = v0 + eb, v0 + ea
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    blk_lo = lo.reshape(n_blk, mk.TRI_BLOCK, 3).min(dim=1).values - 1e-4
    blk_hi = hi.reshape(n_blk, mk.TRI_BLOCK, 3).max(dim=1).values + 1e-4

    def boxes(lo_, hi_):
        out = torch.zeros((lo_.shape[0], 8))
        out[:, 0:3], out[:, 4:7] = lo_, hi_
        return out

    return mk.TriStream(
        geo, torch.zeros((t, mk.TRI_REC_ROWS)), boxes(blk_lo, blk_hi),
        boxes(blk_lo.reshape(n_sup, mk.TRI_SUP, 3).min(dim=1).values,
              blk_hi.reshape(n_sup, mk.TRI_SUP, 3).max(dim=1).values))


def soup(seed, n_sup=3):
    """Clustered random triangles: each block a cluster about its own
    centre, the clusters Morton-like in order along x."""
    g = np.random.default_rng(seed)
    n_blk = n_sup * mk.TRI_SUP
    centre = np.stack([np.linspace(-6.0, 6.0, n_blk),
                       g.uniform(-1, 1, n_blk), g.uniform(-1, 1, n_blk)], 1)
    v0 = (np.repeat(centre, mk.TRI_BLOCK, 0)
          + g.normal(0, 0.25, (n_blk * mk.TRI_BLOCK, 3)))
    ea = g.normal(0, 0.2, v0.shape)
    eb = g.normal(0, 0.2, v0.shape)
    return [torch.from_numpy(x.astype(np.float32)) for x in (ea, eb, v0)]


def rays_at(points, seed, n=2048):
    """Unit rays from a sphere of radius 20 about the origin towards
    `points` (chosen at random), as (o, d) 3-tuples."""
    g = np.random.default_rng(seed)
    p = points[g.integers(0, points.shape[0], n)].numpy()
    o = g.normal(0, 1, (n, 3))
    o = 20.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = p - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    return tuple(o.T), tuple(d.T)


def traversal_case(stream, o, d, group):
    n = o[0].shape[0]
    state = torch.zeros((meshtrace.ST_ROWS, n))
    state[0:3] = torch.stack(o)
    state[3:6] = torch.stack(d)
    state[12] = 1.0
    live = torch.ones(n, dtype=torch.bool)
    best_t = torch.full((n,), mk.BIG)
    order, dist = meshtrace.tile_super_order(state, stream.sup, group)
    return live, best_t, order, dist


def test_traversal_breaks_ties_across_supers_by_row():
    ea, eb, v0 = soup(7)
    last = ea.shape[0] - mk.TRI_SUP * mk.TRI_BLOCK
    # super 0's first two blocks again as the last super's first two
    for x in (ea, eb, v0):
        x[last:last + 2 * mk.TRI_BLOCK] = x[:2 * mk.TRI_BLOCK]
    stream = soup_stream(ea, eb, v0)
    o, d = rays_at(v0[:2 * mk.TRI_BLOCK] + (ea + eb)[:2 * mk.TRI_BLOCK] / 3,
                   seed=8)
    group = 128
    live, best_t, order, dist = traversal_case(stream, o, d, group)
    got, _ = assert_same_hits(o, d, best_t, live, stream, order, dist, group,
                              True)
    assert (got[1] < 2 * mk.TRI_BLOCK).float().mean() > 0.5
    # the last super first: the twins are found first and must lose
    rev = torch.flip(order, dims=[1]).contiguous()
    got_rev, _ = assert_same_hits(o, d, best_t, live, stream, rev,
                                  torch.zeros_like(dist), group, True)
    for g, w in zip(got_rev, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_traversal_finds_winners_in_the_last_super():
    ea, eb, v0 = soup(9)
    stream = soup_stream(ea, eb, v0)
    first = ea.shape[0] - mk.TRI_SUP * mk.TRI_BLOCK
    o, d = rays_at(v0[first:] + (ea + eb)[first:] / 3, seed=10)
    live, best_t, order, dist = traversal_case(stream, o, d, 128)
    got, counts = assert_same_hits(o, d, best_t, live, stream, order, dist,
                                   128, True)
    assert (got[1] >= first).float().mean() > 0.5
    assert counts["staged"] > 0


# ---------------------------------------------------------------------------
# (c) the band, and the restore as an inverse index and a gather
# ---------------------------------------------------------------------------


def random_state(n: int, g) -> torch.Tensor:
    state = g.standard_normal((meshtrace.ST_ROWS, n)).astype(np.float32)
    state[12] = 1.0
    state[meshtrace.LANE_ROW] = np.arange(n, dtype=np.float32)
    return torch.from_numpy(state)


def gather_restore(state):
    """restore as the CUDA kernels compute it: inv[id[j]] = j, then
    out[:, i] = state[:, inv[i]]."""
    n = state.shape[1]
    inv = torch.empty(n, dtype=torch.int64)
    inv[state[meshtrace.LANE_ROW].long()] = torch.arange(n)
    return state[:, inv]


@pytest.mark.parametrize("tiles,death", [(5, 0.25), (12, 0.1), (33, 0.4)])
def test_compaction_stays_in_band_and_gather_restores(tiles, death):
    g = np.random.default_rng(tiles)
    n = tiles * meshtrace.RAY_TILE
    state = random_state(n, g)
    col = torch.arange(n)
    for b in range(meshtrace._HALF_BAND):
        ids = state[meshtrace.LANE_ROW].long()
        state[12] *= torch.from_numpy(g.random(n) >= death).float()
        state[3:6] = torch.from_numpy(
            g.standard_normal((3, n)).astype(np.float32))
        state = meshtrace._compact_pass(state, b)
        ids = state[meshtrace.LANE_ROW].long()
        moved = (ids // meshtrace.RAY_TILE - col // meshtrace.RAY_TILE).abs()
        assert int(moved.max()) <= b + 1
        assert int((ids - col).abs().max()) < (b + 2) * meshtrace.RAY_TILE
    assert not torch.equal(state[meshtrace.LANE_ROW], col.float())
    want = meshtrace.restore_reference(state)
    got = gather_restore(state)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(want[meshtrace.LANE_ROW], col.float())


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bounce_sync_matches_plain_version():
    dev = _cuda()
    for name in ("mesh_large", "mesh_huge"):
        _, _, calls = record_wave(name, dev)
        for b, (state, args, kw) in enumerate(calls):
            want = meshtrace.bounce_sync_reference(state.clone(), *args,
                                                   **kw)
            got = meshtrace.bounce_sync(state.clone(), *args, **kw)
            assert torch.equal(got, want), (name, b)


@pytest.mark.cuda
def test_cuda_kernel_visit_order_is_tile_super_order():
    dev = _cuda()
    for name in ("mesh_large", "mesh_huge"):
        _, stream, calls = record_wave(name, dev)
        for b, (state, _, _) in enumerate(calls):
            order, dist = meshtrace.kernel_visit_order(state, stream.sup)
            want_order, want_dist = meshtrace.tile_super_order(
                state, stream.sup, meshtrace.SYNC_GROUP)
            assert torch.equal(order, want_order), (name, b)
            assert torch.equal(dist.view(torch.int32),
                               want_dist.view(torch.int32)), (name, b)


@pytest.mark.cuda
def test_cuda_restore_matches_plain_version():
    dev = _cuda()
    g = np.random.default_rng(3)
    n = 20 * meshtrace.RAY_TILE
    state = random_state(n, g).to(dev)
    for b in range(meshtrace._HALF_BAND):
        state[12] *= torch.from_numpy(g.random(n) >= 0.2).float().to(dev)
        state = meshtrace._compact_pass(state, b)
    want = meshtrace.restore_reference(state)
    got = meshtrace.restore(state)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


CORRUPT = """
import sys
import torch
from raytracing_in_one_weekend_tpu_torch.ops import meshtrace
n = 4 * meshtrace.RAY_TILE
state = torch.zeros((meshtrace.ST_ROWS, n), device="cuda")
state[meshtrace.LANE_ROW] = torch.arange(n, dtype=torch.float32).flip(0)
meshtrace.restore(state)
torch.cuda.synchronize()  # a valid row passes
state[meshtrace.LANE_ROW, 5] = float(sys.argv[1])
try:
    meshtrace.restore(state)
    torch.cuda.synchronize()
except RuntimeError as err:
    print("raised:", str(err).splitlines()[0])
    sys.exit(0)
sys.exit(3)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["1e9", "-1", "7.0", "7.5", "nan"])
def test_cuda_restore_raises_on_a_corrupt_lane_row(bad):
    _cuda()
    proc = subprocess.run([sys.executable, "-c", CORRUPT, bad], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised:" in proc.stdout
