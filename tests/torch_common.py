"""Shared helpers of the port's tests (the counterpart of pallas_common.py).

They carry a JAX bundle across to the port as plain numpy arrays
(``bundle_from_numpy``), make the same camera rays on both sides from one
numpy seed, and hold the port's primal estimate against the JAX flat
engine's with the rule the Pallas kernel tests use.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uivr_tpu.scene import Scene, finalize_medium
from uivr_tpu.scene.camera import sample_rays
from uivr_tpu.scene.emitters import ConstantEmitter as JConstantEmitter
from uivr_tpu_torch.config import bundle_from_numpy
from uivr_tpu_torch.scene.medium import finalize_medium as t_finalize_medium
from uivr_tpu_torch.scene.scene import Scene as TScene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Imported into a test module, runs its torch ops on one thread: its
    twins step a few thousand lanes per op, where torch's intra-op threads
    cost up to twice the CPU time for about the same wall time, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bundle_to_numpy(b) -> dict:
    """Plain numpy view of a JAX SceneBundle, as ``bundle_from_numpy``
    takes it."""
    a = np.asarray
    cfg = b.medium_cfg
    d = dict(sigma_t=a(b.params.sigma_t), albedo=a(b.params.albedo),
             emission=a(b.params.emission),
             majorant_factor=cfg.majorant_factor, scale=cfg.scale,
             phase_g=cfg.phase_g,
             kernel_majorant_max_cells=cfg.kernel_majorant_max_cells,
             cam_to_world=a(b.cameras.cam_to_world),
             tan_half_fov=a(b.cameras.tan_half_fov),
             aspect=a(b.cameras.aspect), to_world=a(b.to_world),
             film_size=tuple(b.film_size), max_depth=b.max_depth)
    if b.start_from is not None:
        d.update(start_sigma_t=a(b.start_from.sigma_t),
                 start_albedo=a(b.start_from.albedo),
                 start_emission=a(b.start_from.emission))
    e = b.emitter
    if isinstance(e, JConstantEmitter):
        d["radiance"] = a(e.radiance)
    else:
        d.update(env_data=a(e.data), env_alias_tab=a(e.alias_tab),
                 env_flat_data=a(e.flat_data), env_row_pmf=a(e.row_pmf),
                 env_cond_pmf=a(e.cond_pmf), env_to_world=a(e.to_world))
    return d


def both_scenes(jb, device="cpu"):
    """(JAX scene, port bundle, port scene) of one JAX bundle."""
    jsc = Scene(medium=finalize_medium(jb.params, jb.medium_cfg, jb.to_world),
                emitter=jb.emitter, cameras=jb.cameras)
    tb = bundle_from_numpy(bundle_to_numpy(jb), device=device)
    tsc = TScene(medium=t_finalize_medium(tb.params, tb.medium_cfg, tb.to_world),
                 emitter=tb.emitter, cameras=tb.cameras)
    return jsc, tb, tsc


def camera_rays(jb, n=1024, seed=3):
    """The same n camera rays of sensor 0 (JAX-generated) for both sides:
    (o, d) as JAX arrays and as float32 torch tensors on the CPU."""
    rng = np.random.RandomState(seed)
    uv = jnp.asarray(rng.rand(n, 2) * 0.6 + 0.2, jnp.float32)
    o, d = sample_rays(jb.cameras, jnp.zeros((n,), jnp.int32), uv)
    return (o, d), (torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)))


def assert_lanes_agree(L_ref, L, tol_frac=0.025, atol=1e-5):
    """>= (1 - tol_frac) of lanes within ``atol`` on all channels, and the
    channel means within rtol 5e-2 / atol 5e-3.  Lanes may flip at float
    boundaries (different fused arithmetic sends a lane down a different
    but equally valid path); nearly all must match exactly."""
    L_ref, L = np.asarray(L_ref), np.asarray(L)
    agree = np.mean(np.all(np.abs(L_ref - L) < atol, axis=-1))
    assert agree > 1.0 - tol_frac, f"lane agreement {agree}"
    np.testing.assert_allclose(L_ref.mean(0), L.mean(0), rtol=0.05, atol=5e-3)
    return agree


def host_library(src: str, tag: str):
    """Build C++ ``src`` (which includes the kernels' ``.cuh`` lane headers
    with ``__host__``/``__device__`` defined empty) with g++ into a ctypes
    library, cached under ``build/`` by a hash of the source and headers;
    skips the test where g++ is missing."""
    import ctypes
    import hashlib
    import os
    import shutil
    import subprocess

    import pytest

    from uivr_tpu_torch.ops import volpath_step

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    h = hashlib.sha256(src.encode())
    for name in volpath_step.HEADERS:
        h.update((volpath_step.CSRC / name).read_bytes())
    out = volpath_step.build_dir() / "host" / f"lib{tag}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-I", str(volpath_step.CSRC), "-",
                        "-o", str(tmp)], input=src, text=True, check=True,
                       capture_output=True)
        tmp.replace(out)
    return ctypes.CDLL(str(out))
