"""Command-line render driver (counterpart of the JAX package's CLI).

Usage:  python -m raytracing_in_one_weekend_tpu_torch --scene cover --spp 64

Renders on `--device` (default cuda).  Without a CUDA device the command
stops with an error unless `--device cpu` is given, which runs the
kernel's plain PyTorch version on the CPU: an explicit choice, not a
fallback.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracing_in_one_weekend_tpu_torch",
        description="Path tracer (PyTorch / CUDA port)",
    )
    p.add_argument("--scene", default="cover",
                   help="scene name from models.book_scenes / "
                        "models.testbeds")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=64,
                   help="total samples per pixel (slowest pixel)")
    p.add_argument("--depth", type=int, default=35, help="trace depth")
    p.add_argument("--batch-range", type=int, nargs=2, default=(1, 48),
                   metavar=("MIN", "MAX"),
                   help="adaptive samples-per-batch range")
    p.add_argument("--no-adaptive", action="store_true")
    p.add_argument("--interlacing", type=int, default=1)
    p.add_argument("--tonemap", choices=("gamma", "aces"), default="gamma")
    p.add_argument("--noise", choices=("white", "blue", "stbn"),
                   default="white",
                   help="sampler flavor of the pixel-correlated draws "
                        "(RandomSource NoiseColor: blue noise, "
                        "spatio-temporal blue noise)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-duration", type=float, default=None,
                   help="stop after this many seconds")
    p.add_argument("--output", default="render.png")
    p.add_argument("--save-aovs", action="store_true",
                   help="also save normal/albedo AOV PNGs")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from raytracing_in_one_weekend_tpu_torch.models import (
        book_scenes, testbeds,
    )
    from raytracing_in_one_weekend_tpu_torch.render import driver as driver_mod
    from raytracing_in_one_weekend_tpu_torch.utils import image as image_util
    from raytracing_in_one_weekend_tpu_torch.utils.config import (
        NoiseColor, RenderSettings,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available; pass --device cpu to render "
              "with the plain PyTorch version", file=sys.stderr)
        return 2
    registry = {**book_scenes.SCENES, **testbeds.SCENES}
    if args.scene not in registry:
        print(f"error: unknown scene {args.scene!r}; available: "
              f"{', '.join(sorted(registry))}", file=sys.stderr)
        return 2
    scene, camera_settings = registry[args.scene]()
    settings = RenderSettings(
        width=args.width,
        height=args.height,
        samples_per_pixel=args.spp,
        trace_depth=args.depth,
        samples_per_batch_range=tuple(args.batch_range),
        adaptive_sampling=not args.no_adaptive,
        interlacing=args.interlacing,
        noise_color={
            "white": NoiseColor.WHITE,
            "blue": NoiseColor.BLUE,
            "stbn": NoiseColor.SPATIO_TEMPORAL_BLUE,
        }[args.noise],
    )
    r = driver_mod.ProgressiveRenderer(
        scene, camera_settings, settings, seed=args.seed, device=device
    )

    def report(stats):
        if not args.quiet:
            print(
                f"batch {stats.batch_index:4d}  "
                f"{stats.mrays_per_second:8.2f} MRays/s  "
                f"samples/pixel [{stats.min_samples:.0f}, "
                f"{stats.max_samples:.0f}]  "
                f"{stats.duration_s * 1e3:.1f} ms",
                file=sys.stderr,
            )

    r.run(max_duration_seconds=args.max_duration, on_batch=report)

    images = {k: v.cpu().numpy() for k, v in r.images(args.tonemap).items()}
    image_util.write_png(args.output, images["color"])
    if args.save_aovs:
        stem = args.output.rsplit(".", 1)[0]
        image_util.write_png(f"{stem}_normal.png", images["normal"])
        image_util.write_png(f"{stem}_albedo.png", images["albedo"])
    if not args.quiet:
        print(
            f"done on {device}: {r.dispatched_samples_per_pixel} spp "
            f"dispatched (slowest pixel {r.min_samples_per_pixel:.0f} "
            f"valid), avg {r.avg_mrays_per_second:.2f} MRays/s -> "
            f"{args.output}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
