"""Material records and batched scatter (counterpart of the JAX package's
core/materials.py).

Reference: Runtime/Material.cs:16-218.  `pack_materials` resolves the
tables into the (M, 12) record the kernels read; `scatter` is the
wavefront integrator's branchless scatter of every lane at once, for the
Standard (Lambert / GGX metal / glossy), Dielectric and
ProbabilisticVolume (isotropic) materials.  Procedural textures
(checker, Perlin marble, image) are sampled per lane at the hit
(core/textures.py), overriding the packed constants, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_in_one_weekend_tpu_torch.core import (
    math3, microfacet, rng, sampling, textures,
)
from raytracing_in_one_weekend_tpu_torch.core.textures import TextureType
from raytracing_in_one_weekend_tpu_torch.scene.scene import (
    METAL_IOR,
    PLASTIC_IOR,
    MaterialType,
)
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup


@dataclasses.dataclass(frozen=True)
class Scatter(TensorGroup):
    direction: torch.Tensor  # (N, 3) scattered direction
    reflectance: torch.Tensor  # (N, 3) path attenuation for this bounce
    emission: torch.Tensor  # (N, 3)
    random_events: torch.Tensor  # (N,) adaptive-sampling cost signal
    perfect_specular: torch.Tensor  # (N,) bool: gates AOV capture
    logp: torch.Tensor  # (N,) log-probability of this bounce's discrete
    # lottery decisions (specular / metal, dielectric reflect / refract)
    # as a function of the material parameters; the renderer attaches
    # the score-function surrogate to it (integrator.TraceResult.logp)


def pack_materials(scene) -> torch.Tensor:
    """Resolve the material tables into one (M, 12) float32 record:

      0: type | 1:4 albedo | 4:7 emission | 7 gloss | 8 metallic |
      9: parameter (IOR/density) | 10: perfect_specular | 11: pad

    Constant textures resolve here; procedural ones (checker / Perlin /
    image) give 0 and are evaluated per hit by the wavefront (not ported).
    """
    tex = scene.textures
    mats = scene.materials

    def color_of(tex_id):
        t = tex.type[tex_id]
        c = torch.where(
            (t == TextureType.CONSTANT)[:, None],
            tex.main_color[tex_id],
            0.0,
        )
        return torch.where(
            (t == TextureType.CONSTANT_SCALAR)[:, None],
            tex.parameter[tex_id][:, None],
            c,
        )

    def scalar_of(tex_id):
        t = tex.type[tex_id]
        main = tex.main_color[tex_id]
        ch = tex.scalar_channel[tex_id].long()
        s = torch.take_along_dim(main, ch[:, None], dim=-1)[:, 0]
        s = torch.where(t == TextureType.CONSTANT, s, 0.0)
        return torch.where(
            t == TextureType.CONSTANT_SCALAR, tex.parameter[tex_id], s
        )

    albedo = mats.albedo_tex.long()
    emission = mats.emission_tex.long()
    gloss = mats.glossiness_tex.long()
    metallic = mats.metallic_tex.long()
    m = mats.type.shape[0]
    return torch.cat(
        [
            mats.type[:, None].to(torch.float32),
            color_of(albedo),
            color_of(emission),
            scalar_of(gloss)[:, None],
            scalar_of(metallic)[:, None],
            mats.parameter[:, None],
            mats.perfect_specular[:, None].to(torch.float32),
            torch.zeros((m, 1), dtype=torch.float32,
                        device=mats.type.device),
        ],
        dim=1,
    )


def _log_floor(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=1e-12))


def scatter(
    scene,
    ray_direction: torch.Tensor,  # (N, 3)
    normal: torch.Tensor,  # (N, 3) geometric normal at the hit
    point: torch.Tensor,  # (N, 3)
    uv: torch.Tensor,  # (N, 2)
    material: torch.Tensor,  # (N,) int
    key: torch.Tensor,  # the bounce key
    packed: torch.Tensor | None = None,  # (M, 12) from pack_materials
    row: torch.Tensor | None = None,  # (N, >= 11) pre-fetched records
    lambert_tsd: torch.Tensor | None = None,  # (N, 3) pre-drawn
    #   tangent-space cosine directions replacing the Lambert draw
    lambert_tsd_on: bool = False,
) -> Scatter:
    """Scatter every lane at once (Material.cs:68-174): all branches are
    evaluated and blended by material type, the lotteries draw from the
    SCATTER_A stream's six uniforms (a volume's isotropic direction from
    its third and fourth)."""
    if row is None:
        if packed is None:
            packed = pack_materials(scene)
        # (N, 12) rows by index_select (see ops/intersect.gather_rows)
        row = torch.index_select(packed, 0, material.long())
    mtype = row[:, 0].to(torch.int32)
    albedo = row[:, 1:4]
    emission = row[:, 4:7]
    glossiness = row[:, 7]
    metallic = row[:, 8]
    if scene.flags.has_procedural_textures:
        # the texture path (checker / Perlin / image) overrides the packed
        # constants
        mats, tex = scene.materials, scene.textures
        mat = material.long()
        albedo = textures.sample_color(tex, mats.albedo_tex[mat], uv, point,
                                       normal)
        emission = textures.sample_color(tex, mats.emission_tex[mat], uv,
                                         point, normal)
        glossiness = textures.sample_scalar(tex, mats.glossiness_tex[mat],
                                            uv, point, normal)
        metallic = textures.sample_scalar(tex, mats.metallic_tex[mat], uv,
                                          point, normal)
    parameter = row[:, 9]
    perfect_specular = row[:, 10] > 0.5

    n = ray_direction.shape[0]
    ua, ub, uc, ud, u_choice, u_choice2 = rng.uniform(
        rng.purpose_key(key, rng.Purpose.SCATTER_A), (6, n),
        device=ray_direction.device,
    )

    # ---- Standard (Material.cs:75-119) -----------------------------------
    roughness = torch.square(1.0 - glossiness)
    cos_sample = sampling.cosine_hemisphere(ua, ub, normal)
    rough_normal = torch.where(
        (roughness > 0.0)[:, None],
        math3.normalize(math3.lerp(normal, cos_sample, roughness[:, None])),
        normal,
    )
    incident_cos = -math3.dot(ray_direction, rough_normal)
    std_ior = math3.lerp(PLASTIC_IOR, METAL_IOR, metallic)
    fresnel = sampling.schlick(incident_cos, std_ior)
    masking = microfacet.smith_masking_shadowing(ray_direction, normal,
                                                 roughness)
    reflection_chance = math3.saturate(fresnel * glossiness * masking)

    specular_dir = math3.reflect(ray_direction, rough_normal)
    lambert_dir = sampling.cosine_hemisphere(uc, ud, normal)
    if lambert_tsd is not None and lambert_tsd_on:
        lambert_dir = math3.normalize(
            math3.tangent_to_world(lambert_tsd, normal)
        )

    take_specular = (reflection_chance > 0.0) & (u_choice < reflection_chance)
    take_metal = (metallic > 0.0) & (u_choice2 < metallic)
    std_dir = torch.where(
        take_specular[:, None],
        specular_dir,
        torch.where(take_metal[:, None], specular_dir, lambert_dir),
    )
    std_reflectance = torch.where(take_specular[:, None],
                                  torch.ones_like(albedo), albedo)
    # lottery log-probability: specular with reflection_chance, else the
    # metal lottery; the untaken second lottery is left out
    p_spec = math3.saturate(reflection_chance)
    std_logp = torch.where(
        take_specular,
        _log_floor(p_spec),
        _log_floor(1.0 - p_spec) + torch.where(
            take_metal, _log_floor(metallic), _log_floor(1.0 - metallic)
        ),
    )
    # RandomEvents bookkeeping (Material.cs:111-118)
    std_events = (
        torch.where((reflection_chance > 0.0) & (reflection_chance < 1.0),
                    1.0, 0.0)
        + torch.where((metallic > 0.0) & (metallic < 1.0), 1.0, 0.0)
        + roughness * (reflection_chance + (1.0 - reflection_chance)
                       * metallic)
        + (1.0 - reflection_chance) * (1.0 - metallic)
    )

    direction, reflectance, events, logp = (
        std_dir, std_reflectance, std_events, std_logp)

    # ---- Dielectric (Material.cs:121-161) ---------------------------------
    if scene.flags.has_dielectrics:
        d_roughness = 1.0 - glossiness
        sphere_sample = sampling.unit_sphere(ua, ub)
        d_rough_normal = math3.normalize(
            normal + d_roughness[:, None] * sphere_sample
        )
        d_dot = math3.dot(ray_direction, d_rough_normal)
        exiting = d_dot > 0.0
        outward_normal = torch.where(exiting[:, None], -d_rough_normal,
                                     d_rough_normal)
        # other lanes carry parameters (density, 0) whose 1/ior is inf;
        # the logp below consumes refl_prob differentiably, so guard them
        is_diel = mtype == MaterialType.DIELECTRIC
        ior = torch.where(is_diel, torch.clamp(parameter, min=1e-3), 1.5)
        ni_over_nt = torch.where(exiting, ior, 1.0 / ior)
        cosine = torch.where(exiting, ior * d_dot, -d_dot)
        refracted, can_refract = sampling.refract(
            ray_direction, outward_normal, ni_over_nt
        )
        refl_prob = sampling.schlick(cosine, ior)
        do_refract = can_refract & (u_choice > refl_prob)
        diel_dir = torch.where(do_refract[:, None], refracted,
                               math3.reflect(ray_direction, d_rough_normal))
        diel_reflectance = torch.where(do_refract[:, None], albedo,
                                       torch.ones_like(albedo))
        diel_events = 1.0 + d_roughness
        # total internal reflection is deterministic: no probability term
        diel_logp = torch.where(
            can_refract,
            torch.where(do_refract, _log_floor(1.0 - refl_prob),
                        _log_floor(refl_prob)),
            0.0,
        )
        direction = torch.where(is_diel[:, None], diel_dir, direction)
        reflectance = torch.where(is_diel[:, None], diel_reflectance,
                                  reflectance)
        events = torch.where(is_diel, diel_events, events)
        logp = torch.where(is_diel, diel_logp, logp)

    # ---- ProbabilisticVolume isotropic scatter (Material.cs:163-168) ------
    if scene.flags.has_volumes:
        is_vol = mtype == MaterialType.PROBABILISTIC_VOLUME
        direction = torch.where(is_vol[:, None],
                                sampling.unit_sphere(uc, ud), direction)
        reflectance = torch.where(is_vol[:, None], albedo, reflectance)
        events = torch.where(is_vol, 2.0, events)
        # isotropic scatter has no parameter-dependent decision
        logp = torch.where(is_vol, 0.0, logp)

    return Scatter(
        direction=direction,
        reflectance=reflectance,
        emission=emission,
        random_events=events,
        perfect_specular=perfect_specular,
        logp=logp,
    )


def volume_free_path(density: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Beer-Lambert free path d = -1/max(density, 1e-8) * ln(max(u, 1e-12))
    (Material.cs:49-65 ProbabilisticHit)."""
    return -1.0 / torch.clamp(density, min=1e-8) * torch.log(
        torch.clamp(u, min=1e-12))
