"""The paired per-voxel z-test of the gradients (``bench.py:preflight_gate``)
between the port and the JAX package, on the CPU.

The port's flat adjoint (``volpath_flat`` in its deferred mode, the plain
version that the card's kernels equal bit for bit) against JAX's flat
engine (``sample_primal_compact`` + ``sample_adjoint``) on the gate's
inputs: the 32^3 smoke, 4096 rays from ``RandomState(7)``, ``max_depth`` 8,
``max_steps`` 512, ``rr_depth`` 5, ``shadow_rr`` 0.05,
``trans_grad_samples`` 2, dL = 1/(3n), 16 shared seeds from 13.  Each
side renders its own primal per seed.  Per voxel, the mean of the 16
paired differences over its standard error is z ~ t(15) when both are
unbiased estimators of the same gradient.  The gate's own conditions, for
sigma_t and albedo: mean |z| < 1.5, the tail share (z > 6 plus voxels with
a constant nonzero difference, "deterministic bias") under 5 P(|t(15)| >
6) = 1.6e-4, no deterministic-bias voxel, the summed |difference| under
0.25 of the summed |JAX gradient|; and, on the first seed, lane agreement
above 0.25 and channel means within 5%.

Marked slow: 16 seeds of both adjoints take minutes.  Run it with
``python -m pytest tests/test_torch_gate.py -m slow -s``.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import both_scenes
from uivr_tpu.config import smoke_scene
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.integrators import volpath_flat as j_flat
from uivr_tpu.scene.camera import sample_rays
from uivr_tpu_torch.integrators import VolpathConfig, volpath_flat

N = 4096
N_SEEDS = 16
CFG = dict(max_depth=8, max_steps=512, rr_depth=5, shadow_rr=0.05, trans_grad_samples=2)
ZMEAN_THR = 1.5
# bench.py: two-sided P(|t(15)| > 6) = 3.2e-5, with 5x headroom
ZTAIL_THR = max(5 * 3.2e-5, 1e-4)


def z_stats(f_sum, d_sum, d_sq, n_seeds):
    """bench.py:113-143: relative summed difference, mean |z|, tail share
    and deterministic-bias voxels of one grid's paired differences."""
    rel = float(np.abs(d_sum).sum() / max(np.abs(f_sum).sum(), 1e-12))
    mean_d = d_sum / n_seeds
    var_d = np.maximum(d_sq / n_seeds - mean_d ** 2, 0.0) * n_seeds / max(n_seeds - 1, 1)
    sd = np.sqrt(var_d / n_seeds)
    live = sd > 0
    z = np.abs(mean_d[live]) / sd[live]
    floor = 1e-7 * float(np.abs(f_sum).max() / n_seeds + 1e-30)
    n_det = int(((~live) & (np.abs(mean_d) > floor)).sum())
    zmean = float(z.mean()) if z.size else 0.0
    n_all = z.size + n_det
    ztail = float((z > 6.0).sum() + n_det) / n_all if n_all else 0.0
    return {"rel": rel, "zmean": zmean, "ztail6": ztail, "voxels": int(z.size),
            "n_det": n_det}


@pytest.mark.slow
def test_gradients_pass_the_paired_z_test():
    t0 = time.time()
    jb = smoke_scene(res=32, resx=64, resy=64, n_sensors=4, majorant_factor=8)
    jsc, _, tsc = both_scenes(jb)
    rng = np.random.RandomState(7)
    uv = jnp.asarray(rng.rand(N, 2), jnp.float32)
    si = jnp.asarray(rng.randint(0, 4, N), jnp.int32)
    jo, jd = sample_rays(jb.cameras, si, uv)
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    dL = np.full((N, 3), 1.0 / (3 * N), np.float32)
    jcfg, tcfg = JCfg(**CFG), VolpathConfig(**CFG)

    @jax.jit
    def jax_run(seed):
        L, _ = j_flat.sample_primal_compact(jcfg, jsc, jo, jd, seed)
        g = j_flat.sample_adjoint(jcfg, jsc, jo, jd, seed, jnp.asarray(dL), L)
        return L, g.sigma_t, g.albedo

    acc = {k: [0.0, 0.0, 0.0] for k in ("sigma_t", "albedo")}
    first = None
    for seed in range(13, 13 + N_SEEDS):
        Lj, gs, ga = jax.device_get(jax_run(jnp.uint32(seed)))
        Lt, _ = volpath_flat.sample_primal(tcfg, tsc, o, d, seed, deferred=True)
        gt = volpath_flat.sample_adjoint(tcfg, tsc, o, d, seed, torch.from_numpy(dL), Lt,
                                         deferred=True)
        if first is None:
            first = (np.asarray(Lj), Lt.numpy())
        for k, gj in (("sigma_t", gs), ("albedo", ga)):
            f = np.asarray(gj, np.float64)
            dlt = getattr(gt, k).numpy().astype(np.float64) - f
            a = acc[k]
            a[0], a[1], a[2] = a[0] + f, a[1] + dlt, a[2] + dlt * dlt
    Lj, Lt = first
    lane_agree = float(np.mean(np.all(np.abs(Lt - Lj) < 1e-4, axis=-1)))
    mean_rel = float(np.max(np.abs(Lt.mean(0) - Lj.mean(0))
                            / np.maximum(np.abs(Lj.mean(0)), 1e-6)))
    stats = {k: z_stats(*acc[k], N_SEEDS) for k in acc}
    print(f"\n[gate] seconds {time.time() - t0:.1f} lane_agree {lane_agree:.5f} "
          f"mean_rel {mean_rel:.5f} ztail_thr {ZTAIL_THR:g} {stats}")
    assert lane_agree > 0.25 and mean_rel < 0.05
    for k, s in stats.items():
        assert np.isfinite(acc[k][1]).all(), k
        assert s["n_det"] == 0, (k, s)
        assert s["zmean"] < ZMEAN_THR and s["ztail6"] < ZTAIL_THR and s["rel"] < 0.25, (k, s)
