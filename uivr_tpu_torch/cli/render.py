"""Render a registered scene's sensor to EXR through the port.

    python -m uivr_tpu_torch.cli.render --scene janga-smoke --sensor 0 \
        --spp 64 --out render.exr

Renders the scene's ground-truth grids, or a checkpoint's with
``--checkpoint DIR --prefix NAME`` (the ``NAME-medium1_*.vol`` files of a
stage's ``params/`` directory; the ``.vol`` files of either package).
Runs on the GPU (the CUDA path-tracing kernel) unless ``--device cpu``
selects the plain PyTorch path.  Prints the same summary line as
``python -m uivr_tpu.cli.render``.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="tiny-cube")
    ap.add_argument("--integrator", default="volpathsimple-drt")
    ap.add_argument("--sensor", type=int, default=0)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default="render.exr")
    ap.add_argument("--checkpoint", default=None,
                    help="load the grids from this params/ directory instead "
                         "of the ground truth")
    ap.add_argument("--prefix", default="final")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="film resolution scale")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    import torch

    from ..config.registry import get_int_config, get_scene_config
    from ..core import exr_io
    from ..core.device import resolve_device
    from ..opt import load_checkpoint
    from ..render import RenderSettings, render_image

    device = resolve_device(args.device)
    preset = get_scene_config(args.scene)
    bundle = preset.build(device=device)
    if args.scale != 1.0:
        bundle.film_size = (max(8, int(bundle.film_size[0] * args.scale)),
                            max(8, int(bundle.film_size[1] * args.scale)))
    int_cfg = get_int_config(args.integrator).create(max_depth=preset.max_depth)
    params = bundle.params
    if args.checkpoint:
        params = load_checkpoint(args.checkpoint, args.prefix, device=device)
        print(f"[render] loaded {args.prefix} checkpoint from {args.checkpoint}")
    st = RenderSettings(integrator=int_cfg, medium=bundle.medium_cfg,
                        film_size=bundle.film_size, spp=args.spp,
                        spp_grad=args.spp)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    img = render_image(st, params, bundle.emitter, bundle.cameras,
                       args.sensor, seed=args.seed, spp=args.spp,
                       medium_to_world=bundle.to_world)
    dt = time.time() - t0
    exr_io.write_exr(args.out, img)
    W, H = bundle.film_size
    rays = W * H * args.spp
    print(f"[render] {args.out}: {W}x{H} @ {args.spp} spp in {dt:.1f}s "
          f"({rays / dt / 1e6:.3f} Mrays/s), mean={img.mean():.4f}")
    return img, dt


if __name__ == "__main__":
    main()
