"""Reproduction CLI: optimize a registered scene's medium.

    python -m uivr_tpu_torch.cli.reproduce --config janga-smoke \
        --integrator volpathsimple-drt --outputs outputs/ --scale 0.1

Port of ``uivr_tpu/cli/reproduce.py`` for the volumetric path tracers: the
reference images are rendered once per scene with the scene's reference
integrator, then every requested stage trains against them.  ``--scale``
shrinks iteration counts and the batch for smoke runs.  Completed stages
(final checkpoint present) are skipped.  Runs on the GPU unless
``--device cpu`` selects the plain PyTorch path.  Not ported yet: the
``nerf`` stage, ``--mesh`` (data parallel) and ``--retries``.
"""
from __future__ import annotations

import argparse
from dataclasses import replace
from os.path import isfile, join

from ..config.registry import (get_int_config, get_scene_config,
                               list_int_configs, list_scene_configs)
from ..core.device import resolve_device
from ..opt import (OptimizationConfig, load_checkpoint, load_references,
                   render_references, run_optimization)
from ..opt.schedule import Schedule
from ..render import RenderSettings

# Per-scene/integrator optimization overrides, as in the reference.
BASE_OPT = dict(
    spp=16, n_iter=6000, lr=5e-3, primal_spp_factor=64, batch_size=32768,
    lr_schedule=Schedule.Last25, upsample=[0.04, 0.16, 0.36, 0.64],
    preview_spp=64, checkpoint_stride=50,
)
EXPERIMENT_OVERRIDES = {
    ("janga-smoke", "nerf"): dict(lr=1e-2, spp=4, primal_spp_factor=1),
    ("dust-devil", "nerf"): dict(lr=5e-3, spp=4, primal_spp_factor=2),
    ("dust-devil", None): dict(lr=3e-4),
    ("astronaut-rotated", "nerf"): dict(spp=4, primal_spp_factor=2),
    ("rover", "nerf"): dict(lr=1e-2, spp=4, primal_spp_factor=2),
    ("rover", None): dict(lr=5e-2),
    ("tree-2", "nerf"): dict(lr=1e-2, spp=4, primal_spp_factor=2),
    ("tree-2", None): dict(lr=1e-2),
    ("janga-smoke-from-nerf", None): dict(upsample=None),
    ("dust-devil-from-nerf", None): dict(lr=1e-4, upsample=None),
    ("astronaut-rotated-from-nerf", None): dict(upsample=None),
    ("rover-from-nerf", None): dict(lr=1e-2, upsample=None),
    ("tree-2-from-nerf", None): dict(lr=1e-2, upsample=None),
    ("tiny-cube", None): dict(n_iter=600, batch_size=4096, upsample=None),
}


def _opt_for(scene_name: str, int_name: str, scale: float) -> OptimizationConfig:
    kw = dict(BASE_OPT)
    # scene-wide overrides first, integrator-specific ones take precedence
    for key in ((scene_name, None), (scene_name, int_name)):
        kw.update(EXPERIMENT_OVERRIDES.get(key, {}))
    if scale != 1.0:
        kw["n_iter"] = max(20, int(kw["n_iter"] * scale))
        kw["batch_size"] = max(256, int(kw["batch_size"] * min(1.0, scale * 4)))
    kw["name"] = f"{scene_name}/{int_name}"
    return OptimizationConfig(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="tiny-cube", choices=list_scene_configs())
    ap.add_argument("--integrator", nargs="+", default=["volpathsimple-drt"],
                    choices=list_int_configs())
    ap.add_argument("--outputs", default="outputs")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink iters/batch for smoke runs")
    ap.add_argument("--film-scale", type=float, default=1.0,
                    help="scale the film resolution (same cameras/fov)")
    ap.add_argument("--ref-spp", type=int, default=None)
    ap.add_argument("--references", default=None, metavar="DIR",
                    help="load precomputed reference EXRs (ref_%%06d.exr per "
                         "calibrated sensor) instead of rendering them")
    ap.add_argument("--shadow-rr", type=float, default=0.0,
                    help="shadow-walk Russian-roulette threshold of the "
                         "reference render and the volpath stages (0 = off)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over N devices (not ported yet)")
    ap.add_argument("--scan-stride", type=int, default=10,
                    help="accepted for the reference's interface; the port "
                         "runs the host loop, with identical seeds and pixels")
    ap.add_argument("--retries", type=int, default=0,
                    help="re-exec and resume after failures (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which must exist)")
    args = ap.parse_args(argv)

    if "nerf" in args.integrator:
        raise NotImplementedError("nerf: later slice")
    if args.mesh > 0:
        raise NotImplementedError("--mesh (data-parallel training): later slice")
    if args.retries > 0:
        raise NotImplementedError("--retries: later slice")
    device = resolve_device(args.device)

    scene_preset = get_scene_config(args.config)

    def _scale_film(b):
        if args.film_scale != 1.0:
            W, H = b.film_size
            b.film_size = (max(16, int(W * args.film_scale)),
                           max(16, int(H * args.film_scale)))
        return b

    bundle = _scale_film(scene_preset.build(device=device))
    ref_spp = args.ref_spp or scene_preset.ref_spp
    sensors = list(bundle.sensors) if bundle.sensors else None
    if args.references:
        ref_images = load_references(args.references, bundle, sensors=sensors)
        print(f"[refs] loaded precomputed references from {args.references}")
    else:
        ref_bundle = _scale_film(scene_preset.build_ref(device=device))
        ref_int_name = scene_preset.ref_integrator
        if ref_int_name == "path":
            # surface reference scenes: the volume tracer stands in
            ref_int_name = "volpathsimple-basic"
        # the reference images use stock Russian roulette (rr_depth 5)
        ref_int = replace(get_int_config(ref_int_name).create(
            max_depth=scene_preset.max_depth), rr_depth=5)
        if args.shadow_rr > 0:
            ref_int = replace(ref_int, shadow_rr=args.shadow_rr)
        ref_settings = RenderSettings(
            integrator=ref_int, medium=ref_bundle.medium_cfg,
            film_size=ref_bundle.film_size, spp=ref_spp, spp_grad=ref_spp)
        ref_images = render_references(
            ref_bundle, ref_settings, join(args.outputs, args.config, "references"),
            spp=ref_spp,
            sensors=list(ref_bundle.sensors) if ref_bundle.sensors else None)
    _run_stages(args, scene_preset, bundle, ref_images, ref_spp, device)


def _run_stages(args, scene_preset, bundle, ref_images, ref_spp, device):
    """Run every requested integrator stage, warm-started from a finished
    earlier stage where the preset names one."""
    for int_name in args.integrator:
        preset = get_int_config(int_name)
        out_dir = join(args.outputs, args.config, int_name)
        if isfile(join(out_dir, "params", "final-medium1_sigma_t.vol")):
            print(f"[skip] {out_dir} already complete")
            continue
        start_params = None
        if scene_preset.warm_start_from:
            ck_dir = join(args.outputs, scene_preset.warm_start_from)
            if isfile(join(ck_dir, "final-medium1_sigma_t.vol")):
                print(f"[i] warm start from {ck_dir}")
                start_params = load_checkpoint(ck_dir, "final", device=device)
        opt = _opt_for(args.config, int_name, args.scale)
        opt.lr_factors = dict(scene_preset.param_lr_factors)
        opt.scan_stride = args.scan_stride
        int_cfg = preset.create(max_depth=scene_preset.max_depth)
        if args.shadow_rr > 0:
            int_cfg = replace(int_cfg, shadow_rr=args.shadow_rr)
        print(f"[run] scene={args.config} integrator={int_name} "
              f"iters={opt.n_iter} batch={opt.batch_size}")
        run_optimization(out_dir, opt, bundle, int_cfg, ref_images=ref_images,
                         ref_spp=ref_spp, start_params=start_params)
        print(f"[done] {out_dir}")


if __name__ == "__main__":
    main()
