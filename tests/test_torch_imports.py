"""The PyTorch port imports no jax and renders, differentiates and trains
on the CPU on its own."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import pkgutil
import sys

import torch

import raytracing_in_one_weekend_tpu_torch as port
from raytracing_in_one_weekend_tpu_torch.core import camera
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.render import film, renderer

for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    __import__(mod.name)

scene, cs = book_scenes.cover_scene()
cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov, 1.0,
                         aperture=cs.aperture,
                         focus_distance=cs.focus_distance)
acc = film.zero_accumulators(16 * 16)
_, metrics = renderer.render_batch(
    scene, cam, acc, torch.Generator().manual_seed(0),
    width=16, height=16, samples=1, trace_depth=8,
)
assert float(metrics.total_rays) > 0
assert float(acc.sample_count.sum()) > 0

# the differentiable path and the trainer, on the plain versions
from raytracing_in_one_weekend_tpu_torch.diff import inverse, params

centers = scene.spheres.center.clone().requires_grad_()
img = renderer.render_image(params.set_sphere_centers(scene, centers), cam,
                            width=8, height=8, samples_per_pixel=1,
                            trace_depth=3, seed=1)
img.color.mean().backward()
assert bool(torch.isfinite(centers.grad).all())
_, losses = inverse.optimize(
    scene, cam, img.color.detach(),
    {"sphere_centers": scene.spheres.center},
    inverse.InverseRenderConfig(width=8, height=8, samples_per_pixel=1,
                                trace_depth=3, steps=1))
assert len(losses) == 1

# the wavefront: its three arms, the AOV graft and the autofocus raycast
from raytracing_in_one_weekend_tpu_torch.core import rng
from raytracing_in_one_weekend_tpu_torch.render import driver, integrator

key = rng.PRNGKey(3)
rays = camera.generate_rays(cam, camera.pixel_coords(8, 8, key, True), key)
for differentiable, tsd in ((True, None), (False, None),
                            (False, torch.tensor([[0.0, 1.0, 0.0]] * 64))):
    out = integrator.trace(scene, rays, key, 4,
                           differentiable=differentiable,
                           first_bounce_tsd=tsd)
    assert int(out.ray_count) > 0
img = renderer.render_image(params.set_sphere_centers(scene, centers), cam,
                            width=8, height=8, samples_per_pixel=1,
                            trace_depth=3, key=key)
img.normal.sum().backward()
assert bool(torch.isfinite(centers.grad).all())
assert driver.autofocus(scene, cs) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib",
                                    "raytracing_in_one_weekend_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
