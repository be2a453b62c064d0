"""Finite-difference gradient validation through the port.

    python -m uivr_tpu_torch.cli.fd --scene tiny-cube \
        --integrator volpathsimple-drt --spp 512 --eps 5e-3 --out outputs/fd

Port of ``python -m uivr_tpu.cli.fd``, with its flags and its outputs: the
adjoint gradients of ``mean((image - 0.5)^2)`` over a ``res`` x ``res``
grid of pixels of sensor 0 (``adjoint_<key>.npy``), the forward
differences of the same loss over every entry of each grid
(``fd_<key>.npy``), and ``summary.json`` with their correlation and
median and maximum errors relative to the largest FD entry.  Runs on the
GPU (the CUDA kernels render the primal and the adjoint) unless
``--device cpu`` selects the plain PyTorch path.  ``--cls-cells`` sets the
subcell classification budget of the walking kernels (0 = off), the
counterpart of the reference's ``UIVR_CLASS_CELLS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from os.path import join

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="tiny-cube")
    ap.add_argument("--integrator", default="volpathsimple-drt")
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--eps", type=float, default=5e-3)
    ap.add_argument("--res", type=int, default=16, help="image res")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default="outputs/fd")
    ap.add_argument("--keys", nargs="+",
                    default=["sigma_t", "albedo", "emission"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--cls-cells", type=int, default=None,
                    help="subcell classification budget (default: the "
                         "medium's, 8192; 0 = off)")
    args = ap.parse_args(argv)

    import torch

    from ..config.registry import get_int_config, get_scene_config
    from ..core.device import resolve_device
    from ..render import RenderSettings, make_render
    from ..scene.medium import MediumParams
    from ..validation import fd_gradients

    device = resolve_device(args.device)
    preset = get_scene_config(args.scene)
    bundle = preset.build(device=device)
    medium_cfg = bundle.medium_cfg
    if args.cls_cells is not None:
        medium_cfg = dataclasses.replace(medium_cfg, cls_cells=args.cls_cells)
    int_cfg = get_int_config(args.integrator).create(
        max_depth=preset.max_depth)
    st = RenderSettings(integrator=int_cfg, medium=medium_cfg,
                        film_size=bundle.film_size, spp=args.spp,
                        spp_grad=args.spp)
    render = make_render(st, bundle.to_world)

    r = args.res
    W, H = bundle.film_size
    xs, ys = np.meshgrid(np.linspace(0, W - 1, r).astype(np.int32),
                         np.linspace(0, H - 1, r).astype(np.int32))
    pixels = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], -1),
                             dtype=torch.int64, device=device)
    sidx = torch.zeros((pixels.shape[0],), dtype=torch.int64, device=device)
    seed, seed_grad = args.seed, args.seed + 1

    def loss(params):
        img = render(params, bundle.emitter, bundle.cameras, sidx, pixels,
                     seed, seed_grad)
        return torch.mean(torch.square(img - 0.5))

    print(f"[fd] adjoint gradients ({args.integrator})...")
    leaves = MediumParams(*[p.detach().requires_grad_(True)
                            for p in bundle.params])
    g = MediumParams(*torch.autograd.grad(loss(leaves), leaves))
    print(f"[fd] finite differences over "
          f"{sum(getattr(bundle.params, k).numel() for k in args.keys)}"
          f" entries (eps={args.eps})...")
    with torch.no_grad():
        fd = fd_gradients(loss, bundle.params, eps=args.eps,
                          keys=tuple(args.keys))

    os.makedirs(args.out, exist_ok=True)
    summary = {}
    for k in args.keys:
        ga = getattr(g, k).cpu().numpy()
        gf = fd[k]
        np.save(join(args.out, f"adjoint_{k}.npy"), ga)
        np.save(join(args.out, f"fd_{k}.npy"), gf)
        scale = max(np.abs(gf).max(), 1e-12)
        # both sides identically zero (the emission grid under a
        # non-emissive estimator) is exact agreement, not 0/0
        if ga.std() == 0.0 or gf.std() == 0.0:
            corr = 1.0 if np.array_equal(ga, gf) else 0.0
        else:
            corr = float(np.corrcoef(ga.ravel(), gf.ravel())[0, 1])
        summary[k] = {
            "corr": corr,
            "median_rel_err": float(np.median(np.abs(ga - gf)) / scale),
            "max_rel_err": float(np.abs(ga - gf).max() / scale),
        }
        print(f"  {k}: {summary[k]}")
    with open(join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[fd] wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
