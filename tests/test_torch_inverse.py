"""The port's trainer (diff/inverse.py) and parameter plumbing
(diff/params.py).

The JAX package's make_loss_fn draws its batch seed with jax.random and,
on the CPU, renders through the wavefront integrator, so the two cannot
be put on one tape; the first step's gradient is held instead to the
port's sample_batch_diff gradient on the seed the trainer draws.
"""

import dataclasses

import pytest
import torch

from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.diff import inverse
from raytracing_in_one_weekend_tpu_torch.diff import params as params_mod
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.render import renderer

W = 16
CONFIG = inverse.InverseRenderConfig(width=W, height=W, samples_per_pixel=2,
                                     trace_depth=4, learning_rate=2e-2,
                                     steps=3)


def setup():
    scene, cs = book_scenes.three_spheres()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    target = renderer.render_image(scene, cam, width=W, height=W,
                                   samples_per_pixel=4, trace_depth=4,
                                   seed=99, differentiable=False).color
    init = {"sphere_centers": scene.spheres.center
            + torch.tensor([0.05, -0.03, 0.0])}
    return scene, cam, target, init


def test_optimize_takes_finite_steps_and_moves_the_parameters():
    scene, cam, target, init = setup()
    seen = []
    out, losses = inverse.optimize(
        scene, cam, target, init, CONFIG, seed=4,
        callback=lambda i, p, loss: seen.append((i, loss)))
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))
    assert [i for i, _ in seen] == [0, 1, 2]
    moved = (out["sphere_centers"] - init["sphere_centers"]).abs().max()
    assert 0.0 < float(moved) <= 3 * CONFIG.learning_rate * 1.01


def test_first_step_gradient_is_the_sample_batch_diff_gradient():
    scene, cam, target, init = setup()
    loss_fn = inverse.make_loss_fn(scene, cam, target, CONFIG)
    params = {k: v.clone().requires_grad_() for k, v in init.items()}
    loss = loss_fn(params, torch.Generator().manual_seed(4))
    (grad,) = torch.autograd.grad(loss, [params["sphere_centers"]])

    # the seed render_batch draws from the trainer's generator
    seed = int(torch.randint(0, renderer.SEED_RANGE, (),
                             generator=torch.Generator().manual_seed(4)))
    centers = init["sphere_centers"].clone().requires_grad_()
    records = megatrace.pack_sphere_records(scene,
                                            materials.pack_materials(scene))
    n = W * W
    d = mr.sample_batch_diff(
        torch.full((n,), 2, dtype=torch.int32), torch.zeros(n),
        megatrace.pack_camera_row(cam, W, W), centers, scene.spheres.radius,
        records, scene.environment.sky_bottom, scene.environment.sky_top,
        seed, samples=2, trace_depth=4,
        has_dielectrics=scene.flags.has_dielectrics)
    count = d["count"]
    img = torch.where((count == 0)[:, None], 0.0,
                      d["color"] / torch.clamp(count, min=1.0)[:, None])
    want_loss = torch.mean((img - target) ** 2)
    (want,) = torch.autograd.grad(want_loss, [centers])
    assert float(loss.detach()) == float(want_loss.detach())
    assert float(grad.abs().max()) > 0
    torch.testing.assert_close(grad, want, rtol=1e-6, atol=1e-9)

    _, losses = inverse.optimize(scene, cam, target, init,
                                 CONFIG._replace(steps=1), seed=4)
    assert losses[0] == float(loss.detach())


def test_albedo_fit_converges():
    """Albedos reach the image without silhouettes, so Adam on them must
    close in on the target's: a gradient of the wrong sign or scale fails
    (from 0.5, five steps at lr 5e-2 leave a max error of ~0.26)."""
    scene, cam, target, _ = setup()
    rows = [1, 3, 4]  # the Lambert center and ground, the metal sphere
    true = scene.textures.main_color
    start = true.clone()
    start[rows] = 0.5
    out, losses = inverse.optimize(
        scene, cam, target, {"texture_colors": start},
        CONFIG._replace(steps=5, learning_rate=5e-2), seed=0,
        project=lambda p: {"texture_colors": p["texture_colors"].clamp(0, 1)})
    assert torch.isfinite(torch.tensor(losses)).all()
    err = (out["texture_colors"] - true)[rows].abs()
    assert float(err.max()) < 0.35, err


def test_grad_mask_freezes_and_project_clamps():
    scene, cam, target, init = setup()
    mask = {"sphere_centers": torch.zeros_like(init["sphere_centers"])}
    mask["sphere_centers"][0] = 1.0
    out, _ = inverse.optimize(
        scene, cam, target, init, CONFIG._replace(steps=2), seed=1,
        grad_mask=mask,
        project=lambda p: {"sphere_centers": torch.clamp(
            p["sphere_centers"], max=init["sphere_centers"] + 0.01)})
    delta = out["sphere_centers"] - init["sphere_centers"]
    assert torch.all(delta[1:] == 0.0)
    assert float(delta[0].abs().max()) > 0
    assert torch.all(delta <= 0.01 + 1e-7)


def test_unbiased_l2_and_boundary_refusal():
    scene, cam, target, init = setup()
    _, losses = inverse.optimize(
        scene, cam, target, init,
        CONFIG._replace(steps=1, unbiased_l2=True), seed=2)
    assert torch.isfinite(torch.tensor(losses)).all()
    with pytest.raises(NotImplementedError, match="step 12"):
        inverse.optimize(scene, cam, target, init,
                         CONFIG._replace(use_boundary=True))


def test_params_round_trip():
    scene, _ = book_scenes.three_spheres()
    names = ("sphere_centers", "sphere_radii", "texture_colors",
             "material_parameters")
    got = params_mod.extract_params(scene, names)
    new = {k: v + 1.0 for k, v in got.items()}
    moved = params_mod.apply_params(scene, new)
    back = params_mod.extract_params(moved, names)
    for k in names:
        assert torch.equal(back[k], new[k]), k
    # the template is untouched, and other fields are shared
    assert torch.equal(params_mod.extract_params(scene, names)[names[0]],
                       got[names[0]])
    assert moved.spheres.material is scene.spheres.material
    verts = torch.arange(18, dtype=torch.float32).reshape(2, 3, 3)
    tri = dataclasses.replace(
        scene, triangles=dataclasses.replace(scene.triangles,
                                             vert0=verts[:, 0]))
    tri = params_mod.set_triangle_vertices(tri, verts)
    assert torch.equal(params_mod.soup_vertices(tri), verts)
