"""Rank functions of tests/test_torch_parallel.py.

``uivr_tpu_torch.parallel.spawn`` runs them in new processes, which import
this module by name; it imports no JAX, so a rank starts with torch and the
port only.
"""
import numpy as np
import torch

from uivr_tpu_torch.config import bundle_from_numpy
from uivr_tpu_torch.integrators import VolpathConfig
from uivr_tpu_torch.opt import losses
from uivr_tpu_torch.parallel import replicate, shard_batch, sharded_loss_and_grad
from uivr_tpu_torch.render.batched import RenderSettings, make_render


def render_of(bundle_np: dict, cfg: dict, spp: int):
    """(port bundle on the CPU, the differentiable batch render) of a
    numpy bundle."""
    tb = bundle_from_numpy(bundle_np, device="cpu")
    st = RenderSettings(integrator=VolpathConfig(**cfg), medium=tb.medium_cfg,
                        film_size=tb.film_size, spp=spp, spp_grad=spp)
    return tb, make_render(st, tb.to_world)


def sharded_step(mesh, bundle_np, cfg, spp, batch, seeds, out_path):
    """One ``sharded_loss_and_grad`` step of the global ``batch``
    (sensor_idx, pixels, ref as numpy) from the bundle's grids; writes this
    rank's loss and gradients to ``out_path % rank``."""
    tb, render = render_of(bundle_np, cfg, spp)
    vag = sharded_loss_and_grad(mesh, render, losses.l1)
    sidx, pix, ref = shard_batch(mesh, batch)
    params = replicate(mesh, tb.params)
    loss, grads = vag(params, tb.emitter, tb.cameras, sidx, pix, ref, *seeds)
    np.savez(out_path % mesh.rank, loss=loss.numpy(),
             **{k: g.numpy() for k, g in zip(grads._fields, grads)})
    assert torch.equal(params.sigma_t, tb.params.sigma_t)
