"""Inverse rendering: optimize scene parameters from a target image
(counterpart of the JAX package's diff/inverse.py).

One step renders with the current parameters (`render_image`,
differentiable: the batch kernel with its tape, then the tape replay's
backward kernel), takes the L2 loss against the target, backpropagates
and applies an Adam update.  Each step draws a fresh batch seed from a
`torch.Generator` seeded by `seed`, so the Monte Carlo gradients are
re-randomised from step to step.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from raytracing_in_one_weekend_tpu_torch.core.camera import Camera
from raytracing_in_one_weekend_tpu_torch.diff import params as params_mod
from raytracing_in_one_weekend_tpu_torch.render import renderer
from raytracing_in_one_weekend_tpu_torch.scene.scene import Scene


class InverseRenderConfig(NamedTuple):
    width: int = 64
    height: int = 64
    samples_per_pixel: int = 8
    trace_depth: int = 6
    learning_rate: float = 2e-2
    steps: int = 100
    # Silhouette boundary gradients (the JAX package's diff/boundary.py,
    # with its boundary_samples / boundary_probe_spp settings): not ported
    # yet (ROADMAP queue 1, step 12); True raises.
    use_boundary: bool = False
    # Unbiased L2: E[(X-t)(Y-t)] = (E[X]-t)^2 for independent renders X, Y;
    # the plain Monte Carlo L2 carries a +Var(X) term that rewards variance
    # reduction.  Costs two renders per step, each at half the spp.
    unbiased_l2: bool = False


def make_loss_fn(
    scene_template: Scene,
    camera: Camera,
    target_image: torch.Tensor,  # (P, 3) linear
    config: InverseRenderConfig,
) -> Callable[[dict[str, Any], torch.Generator], torch.Tensor]:
    """loss_fn(params, generator): the photometric loss of one render (two
    with `unbiased_l2`), each drawing its batch seed from `generator`."""

    def render_color(params, generator, spp):
        scene = params_mod.apply_params(scene_template, params)
        return renderer.render_image(
            scene, camera, generator,
            width=config.width, height=config.height,
            samples_per_pixel=spp, trace_depth=config.trace_depth,
        ).color

    if config.unbiased_l2:

        def loss_fn(params, generator):
            spp = max(1, config.samples_per_pixel // 2)
            ra = render_color(params, generator, spp) - target_image
            rb = render_color(params, generator, spp) - target_image
            return torch.mean(ra * rb)

    else:

        def loss_fn(params, generator):
            img = render_color(params, generator, config.samples_per_pixel)
            return torch.mean((img - target_image) ** 2)

    return loss_fn


def optimize(
    scene_template: Scene,
    camera: Camera,
    target_image: torch.Tensor,
    init_params: dict[str, Any],
    config: InverseRenderConfig = InverseRenderConfig(),
    seed: int = 0,
    callback=None,
    grad_mask: dict[str, Any] | None = None,
    project: Callable[[dict[str, Any]], dict[str, Any]] | None = None,
) -> tuple[dict[str, torch.Tensor], list[float]]:
    """Adam descent on the photometric loss, a fresh sample stream per
    step.  Returns the final parameters (detached) and the loss of every
    step.  `init_params` is keyed by diff/params' names
    ("sphere_centers", "texture_colors", "material_parameters": the IOR
    and volume density table, ...).

    grad_mask: optional dict matching init_params; gradients are
    multiplied elementwise (1 = optimize, 0 = freeze).
    project: optional projection applied to the parameters after each
    update (projected gradient descent), e.g. clamping albedos to [0, 1].
    callback(i, params, loss) is called after every step."""
    if config.use_boundary:
        raise NotImplementedError(
            "silhouette boundary gradients are not ported yet "
            "(ROADMAP queue 1, step 12); pass use_boundary=False"
        )
    params = {k: v.detach().clone().requires_grad_()
              for k, v in init_params.items()}
    optimizer = torch.optim.Adam(list(params.values()),
                                 lr=config.learning_rate)
    loss_fn = make_loss_fn(scene_template, camera, target_image, config)
    generator = torch.Generator().manual_seed(seed)
    losses: list[float] = []
    for i in range(config.steps):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, generator)
        loss.backward()
        if grad_mask is not None:
            for k, m in grad_mask.items():
                if params[k].grad is not None:
                    params[k].grad.mul_(m)
        optimizer.step()
        if project is not None:
            with torch.no_grad():
                for k, v in project(params).items():
                    params[k].copy_(v)
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, params, losses[-1])
    return {k: v.detach() for k, v in params.items()}, losses
