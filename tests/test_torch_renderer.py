"""The forward slice end to end: renderer, driver and CLI of the port
against the JAX package.

* Two consecutive adaptive, interlaced batches of the port's render_batch
  against JAX render_batch (fused arm, Pallas kernel in interpret mode),
  fed the seed JAX drew: accumulators agree per pixel within
  atol=rtol=1e-4 on >= 99% of pixels, metrics' total_rays within 0.5%.
  The normal channels of the cover are held to the bound that
  tests/test_torch_megatrace.py derives and traces to XLA's CPU rsqrt
  (0.95 of pixels), and on pixels whose other channels all agree to an
  error below 1e-2 per sample, which rounding stays under.
* The port's 96x64, 16 spp cover render against the stored golden
  (tests/golden/cover_96x64.npz, rendered by the JAX wavefront with
  threefry draws, so only statistics compare): image mean within 3%,
  and the MAE of 8x8-block means below 0.0074.  That bound is twice the
  JAX fused kernel's own block MAE against the same golden (0.00368,
  interpret mode, hash PRNG, PRNGKey(42)); the port measured
  0.0032-0.0037 over generator seeds 0, 1 and 42.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace, pallas_sphere
from raytracing_in_one_weekend_tpu.render import film as jax_film
from raytracing_in_one_weekend_tpu.render import renderer as jax_renderer
from raytracing_in_one_weekend_tpu_torch import __main__ as cli
from raytracing_in_one_weekend_tpu_torch.core import camera
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.render import driver, film, renderer
from raytracing_in_one_weekend_tpu_torch.utils.config import (
    DenoiseMode,
    RenderSettings,
)

TOL = dict(atol=1e-4, rtol=1e-4)
PIXEL_SHARE = 0.99
COVER_NORMAL_SHARE = 0.95  # tests/test_torch_megatrace.py docstring
COVER_NORMAL_MAX_ERR = 1e-2  # per sample, on pixels on the same paths
GOLDEN = "tests/golden/cover_96x64.npz"
GOLDEN_BLOCK_MAE = 0.0074


def _cameras(cs, w, h):
    kw = dict(aperture=cs.aperture, focus_distance=cs.focus_distance)
    return (
        jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                               cs.vertical_fov, w / h, **kw),
        camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                           w / h, **kw),
    )


def test_two_adaptive_interlaced_batches_match_jax(monkeypatch):
    monkeypatch.setattr(pallas_megatrace, "FORCE_INTERPRET", True)
    monkeypatch.setattr(pallas_sphere, "use_pallas", lambda: True)
    w = h = 32
    js, cs = jax_scenes.cover_scene()
    ts, _ = book_scenes.cover_scene()
    jcam, tcam = _cameras(cs, w, h)
    jacc = jax_film.zero_accumulators(w * h)
    tacc = film.zero_accumulators(w * h)
    jext = jnp.zeros(2, jnp.float32)
    text = torch.zeros(2)
    kw = dict(width=w, height=h, samples=4, trace_depth=8,
              sample_range=(1, 4), differentiable=False)
    for batch, offset in enumerate((0, 1)):
        key = jax.random.PRNGKey(100 + batch)
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
        jacc, jm = jax_renderer.render_batch(
            js, jcam, jacc, key, interlace=(offset, 2),
            weight_extrema=jext, **kw,
        )
        _, tm = renderer.render_batch(
            ts, tcam, tacc, interlace=(offset, 2), weight_extrema=text,
            seed=seed, **kw,
        )
        names = [f.name for f in dataclasses.fields(tacc)]
        got = {k: getattr(tacc, k).numpy() for k in names}
        want = {k: np.asarray(getattr(jacc, k)) for k in names}
        close = {}
        for k in names:
            c = np.isclose(got[k], want[k], **TOL)
            close[k] = c.all(axis=1) if c.ndim == 2 else c
            bound = (COVER_NORMAL_SHARE if k.endswith("normal")
                     else PIXEL_SHARE)
            assert close[k].mean() >= bound, (batch, k, close[k].mean())
        # pixels whose other channels all agree followed the same paths:
        # there each sample's normal may differ by rounding only
        same = np.all([close[k] for k in names if not k.endswith("normal")],
                      axis=0)
        samples = np.maximum(got["sample_count"][same], 1.0)
        for k in ("normal", "fallback_normal"):
            err = np.abs(got[k] - want[k])[same].max(axis=1)
            assert np.all(err < COVER_NORMAL_MAX_ERR * samples), \
                (batch, k, err.max())
        got_rays, want_rays = float(tm.total_rays), float(jm.total_rays)
        assert abs(got_rays - want_rays) <= 0.005 * want_rays
        assert float(tm.total_samples) == pytest.approx(
            float(jm.total_samples), rel=0.005)
        jext = jnp.stack([jm.weight_min, jm.weight_max])
        text = torch.stack([tm.weight_min, tm.weight_max])
        np.testing.assert_allclose(text.numpy(), np.asarray(jext), rtol=0.01)
    # interlacing: batch 0 filled the even rows, batch 1 the odd rows
    rows = tacc.sample_count.reshape(h, w)
    assert bool((rows[0::2] > 0).any()) and bool((rows[1::2] > 0).any())


def test_cover_matches_golden_statistically():
    w, h = 96, 64
    scene, cs = book_scenes.cover_scene()
    _, cam = _cameras(cs, w, h)
    img = renderer.render_image(
        scene, cam, torch.Generator().manual_seed(42), width=w, height=h,
        samples_per_pixel=16, trace_depth=8,
    )
    got = img.color.numpy()
    want = np.load(GOLDEN)["color"].astype(np.float32)
    assert np.isfinite(got).all() and got.mean() > 0.2
    assert abs(got.mean() - want.mean()) <= 0.03 * want.mean()

    def blocks(x):
        return x.reshape(h // 8, 8, w // 8, 8, 3).mean(axis=(1, 3))

    mae = np.abs(blocks(got) - blocks(want)).mean()
    assert mae < GOLDEN_BLOCK_MAE, mae


def test_cli_writes_png_on_cpu(tmp_path):
    out = tmp_path / "cover.png"
    rc = cli.main([
        "--scene", "cover", "--width", "32", "--height", "32", "--spp", "2",
        "--depth", "4", "--device", "cpu", "--output", str(out),
        "--save-aovs", "--quiet",
    ])
    assert rc == 0
    for path in (out, tmp_path / "cover_normal.png",
                 tmp_path / "cover_albedo.png"):
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_refuses_cuda_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(["--scene", "single_sphere", "--output",
                   str(tmp_path / "x.png")])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_progressive_renderer_runs_to_completion():
    scene, cs = book_scenes.three_spheres()
    settings = RenderSettings(width=16, height=12, samples_per_pixel=4,
                              trace_depth=6, samples_per_batch_range=(1, 2),
                              interlacing=2)
    r = driver.ProgressiveRenderer(scene, cs, settings, seed=3, device="cpu")
    r.run()
    assert r.complete and r.batch_index == 8
    assert r.avg_mrays_per_second > 0
    assert sum(b.rays for b in r.history) > 0
    images = r.images()
    assert images["color"].shape == (12, 16, 3)
    assert images["color"].dtype == torch.uint8
    color = r.combined().color
    assert bool(torch.isfinite(color).all()) and float(color.mean()) > 0.2
    r.reset()
    assert r.batch_index == 0 and float(r.acc.sample_count.sum()) == 0


def test_driver_refuses_unported_features():
    scene, cs = book_scenes.three_spheres()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        driver.ProgressiveRenderer(
            scene, cs, RenderSettings(denoise_mode=DenoiseMode.ATROUS),
            device="cpu",
        )
    # the autofocus raycast is ported (tests/test_torch_integrator.py)
    focus = driver.autofocus(scene, dataclasses.replace(cs,
                                                        focus_distance=None))
    assert 0.0 < focus < 1e29
    motion, mcs = book_scenes.SCENES["cover_motion"]()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        driver.ProgressiveRenderer(motion, mcs, RenderSettings(),
                                   device="cpu")
    # volume (convex volumes, ROADMAP step 7.2) renders now
    volume, vcs = book_scenes.volume_test()
    r = driver.ProgressiveRenderer(
        volume, vcs, RenderSettings(width=12, height=8,
                                    samples_per_pixel=2, trace_depth=4),
        device="cpu")
    r.run()
    assert bool(torch.isfinite(r.combined().color).all())
    # cornell (rects and boxes, ROADMAP step 7.1) renders now
    cornell, ccs = book_scenes.cornell_box()
    r = driver.ProgressiveRenderer(
        cornell, ccs, RenderSettings(width=12, height=8,
                                     samples_per_pixel=2, trace_depth=4),
        device="cpu")
    r.run()
    color = r.combined().color
    assert bool(torch.isfinite(color).all()) and float(color.mean()) > 0.0
