"""The port's public names held against the JAX package's, name by name.

- ``uivr_tpu_torch`` has every module of ``uivr_tpu`` at the same path, and
  each public name of a module (its functions, classes and constants, and
  what an ``__init__.py`` re-exports) is defined or imported at the top
  level of the port's module of the same path, unless it stands in the fixed lists below, each entry
  with its reason: names renamed because the card has no Pallas, and the
  TPU workarounds the port leaves out.  Each parameter of a public
  function both packages define is a parameter of the port's (the port may
  add some, such as ``device``).  No module of the port imports ``jax`` or
  ``uivr_tpu``.  All of this by ``ast``, without importing JAX's modules;
- ``config.scene_from_files`` against JAX's on ``.vol`` and EXR files
  written from a numpy seed: the grids, start grids, ``to_world``, cameras
  and the emitter's tables within 1e-6, with and without an envmap, with
  one- and three-channel albedo;
- on one 16^3 smoke medium: ``scene.medium.albedo_at``, ``majorant_at``,
  ``global_majorant_of`` at random points inside and outside the box;
  ``scene.scene.update_medium_params``' supergrid;
  ``core.rng.lane_next_2d`` bit for bit; ``integrators.common.zero_grads``;
  ``volpath_flat.sample_primal_compact`` bit-equal to the port's
  ``sample_primal`` and, against JAX's compact primal, within the
  lane-agreement rule of ``tests/pallas_common.py``;
  ``nerf.sample_adjoint(grads=)`` equal to the sum of two fresh calls
  within 1e-6 relative L1 (another order of the same float32 sums);
- the 64-bit index arithmetic of ``ops/csrc/nerf.cuh`` (``nerf_cell``,
  ``NerfMarch::corner`` at ``Idx = int64_t``), built with g++, against
  numpy int64 at 1024x1024x512 and 1024x1024x2048 voxels (no grid
  allocated), and its int32_t form at 128^3.
"""
import ast
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import assert_lanes_agree, both_scenes, camera_rays, host_library
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import scene_from_files as j_scene_from_files
from uivr_tpu.config import smoke_scene
from uivr_tpu.core import rng as j_rng
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.integrators import volpath_flat as j_flat
from uivr_tpu.scene import medium as j_medium
from uivr_tpu.scene import scene as j_scene
from uivr_tpu.scene.medium import MediumParams as JParams
from uivr_tpu_torch.config import scene_from_files
from uivr_tpu_torch.core import exr_io, rng, vol_io
from uivr_tpu_torch.integrators import NerfConfig, VolpathConfig, nerf, volpath_flat, zero_grads
from uivr_tpu_torch.scene import albedo_at, majorant_at, update_medium_params
from uivr_tpu_torch.scene.gradients import init_accum
from uivr_tpu_torch.scene.medium import MediumParams, global_majorant_of

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "uivr_tpu", ROOT / "uivr_tpu_torch"
SEED = 42

# (module path, JAX name): (the port's name, why)
RENAMED = {
    ("ops/volpath_step.py", "sample_primal_pallas"): (
        "sample_primal_kernel", "no Pallas on the card: the CUDA primal kernel's wrapper"),
    ("ops/volpath_step.py", "sample_primal_persistent"): (
        "sample_primal_kernel", "no Pallas on the card: the primal kernel is persistent"),
    ("ops/volpath_step.py", "sample_adjoint_pallas"): (
        "sample_adjoint_kernel", "no Pallas on the card: the CUDA adjoint kernel's wrapper"),
    ("ops/volpath_step.py", "sample_adjoint_persistent"): (
        "sample_adjoint_kernel", "no Pallas on the card: the adjoint kernel is persistent"),
    ("utils/profiling.py", "xla_trace"): (
        "trace", "a torch.profiler trace stands for the XLA trace"),
    ("utils/__init__.py", "xla_trace"): (
        "trace", "the re-export of utils/profiling.xla_trace, renamed with it"),
}
_CORNER_TABLES = "TPU corner tables (32-float rows): the kernels read one float4 a corner"
_PLANES = "the TPU step kernel's (R, 128) planes and Pallas tables: CUDA lanes keep registers"
# (module path, JAX name): why the port leaves it out
EXCLUDED = {
    ("core/grids.py", "build_corner_table"): _CORNER_TABLES,
    ("core/grids.py", "fold_corner_table"): _CORNER_TABLES,
    ("core/grids.py", "trilinear_sample_ct"): _CORNER_TABLES,
    ("core/grids.py", "trilinear_scatter_ct"): _CORNER_TABLES,
    **{("ops/volpath_step.py", name): _PLANES for name in (
        "ADJ_F32", "ADJ_I32", "ADJ_PLANES", "ALL_PLANES", "AdjCarry", "F32_PLANES",
        "I32_PLANES", "N_ADJ", "N_ALL", "N_STATE", "PRE_PLANES", "PlanesCarry", "StepSpec",
        "StepTables", "build_tables", "pack_carry", "unpack_carry",
        # the bits of the planes' "flags" plane (pack_carry, unpack_carry)
        "FL_ESC", "FL_SCAT", "FL_POST")},
    ("ops/volpath_step.py", "pallas_supported"):
        "the gate of the fallback to the flat engine: the kernels take every scene",
}
# (module path, function, parameter): why the port's function lacks it
EXCLUDED_PARAMS = {
    ("scene/gradients.py", "init_accum", "vary"):
        "shard_map's varying zero of the TPU corner-table accumulators",
    ("integrators/volpath_flat.py", "sample_adjoint", "schedule"):
        "the sizes of XLA's compaction rounds: the port steps only live lanes",
}


def _top_level(tree):
    """The module's top-level statements, those of its top-level ``if`` and
    ``try`` blocks included."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.If, ast.Try)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            todo += [s for h in getattr(node, "handlers", []) for s in h.body]
        else:
            yield node


def _public(path: Path, init: bool, imports: bool = False):
    """{public name: parameter names (functions) or None} of a module: its
    definitions and assignments, and in an ``__init__.py`` what it imports
    from the package; with ``imports``, every name it imports."""
    out = {}
    for node in _top_level(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            out[node.name] = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out[n.id] = None
        elif isinstance(node, ast.Import) and imports:
            for al in node.names:
                out[al.asname or al.name.split(".")[0]] = None
        elif isinstance(node, ast.ImportFrom) and (imports or (init and node.level)):
            for al in node.names:        # in an __init__.py: the package's modules and names
                out[al.asname or al.name] = None
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _modules(pkg: Path):
    return {p.relative_to(pkg).as_posix(): p for p in sorted(pkg.rglob("*.py"))}


def _foreign_imports(path: Path, rel: str):
    """The imports of ``jax`` or ``uivr_tpu`` anywhere in a port module,
    relative imports that climb out of the port's package included."""
    depth = rel.count("/") + 1          # a relative import of this level is the package
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [al.name for al in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level > depth:
                bad.append(f"{'.' * node.level}{node.module or ''}")
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "uivr_tpu")]
    return bad


def test_public_names_match_jax_package():
    """Every public name and parameter of ``uivr_tpu`` in the port, but for
    the fixed lists; no ``jax`` or ``uivr_tpu`` import in the port."""
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    assert not set(jax_mods) - set(port_mods), sorted(set(jax_mods) - set(port_mods))
    missing, params, listed = [], [], set()
    for rel, path in jax_mods.items():
        init = rel.endswith("__init__.py")
        port_defs = _public(port_mods[rel], init, imports=True)
        for name, args in _public(path, init).items():
            key = (rel, name)
            if key in EXCLUDED:
                listed.add(key)
                assert name not in port_defs, f"{key} is excluded but exists"
                continue
            if key in RENAMED:             # another function: no parameters to compare
                listed.add(key)
                if RENAMED[key][0] not in port_defs:
                    missing.append(key)
                continue
            if name not in port_defs:
                missing.append(key)
                continue
            theirs = port_defs[name]
            if args is None or theirs is None:
                continue
            for a in args:
                if (rel, name, a) in EXCLUDED_PARAMS:
                    listed.add((rel, name, a))
                elif a not in theirs:
                    params.append((rel, name, a))
    assert not missing, f"public names of uivr_tpu without a counterpart: {missing}"
    assert not params, f"parameters the port's functions lack: {params}"
    # every entry of the fixed lists names something the JAX package has
    fixed = set(EXCLUDED) | set(RENAMED) | set(EXCLUDED_PARAMS)
    assert listed == fixed, sorted(fixed - listed)
    foreign = {rel: b for rel, p in port_mods.items() if (b := _foreign_imports(p, rel))}
    assert not foreign, f"the port imports jax or uivr_tpu: {foreign}"


def _write_assets(tmp_path, rs, albedo_channels):
    """sigma, albedo and emission ``.vol`` files (12x10x8 voxels, one bbox)
    and an 8x16 EXR map; returns their paths."""
    D, H, W = 8, 10, 12
    bbox = (-0.5, -0.25, -1.0, 0.7, 0.9, 0.4)
    paths = {}
    for name, ch in (("sigma", 1), ("albedo", albedo_channels), ("emission", 1)):
        paths[name] = str(tmp_path / f"{name}.vol")
        vol_io.write_vol(paths[name], rs.rand(D, H, W, ch).astype(np.float32), bbox)
    paths["env"] = str(tmp_path / "env.exr")
    exr_io.write_exr(paths["env"], (rs.rand(8, 16, 3) * 4.0 + 0.1).astype(np.float32))
    return paths


def test_scene_from_files_matches_jax(tmp_path):
    """``scene_from_files`` of both packages on the same files: with an
    EXR map and one-channel albedo, the bbox mapped onto the world; without
    a map (the unit constant emitter) and three-channel albedo under a
    given ``to_world``."""
    rs = np.random.RandomState(5)
    T = np.diag([1.5, 2.0, 1.25, 1.0]).astype(np.float32)
    T[:3, 3] = [0.1, -0.3, 0.2]
    for case, (albedo_ch, env, to_world) in {"envmap": (1, True, None),
                                            "constant": (3, False, T)}.items():
        (tmp_path / case).mkdir()
        p = _write_assets(tmp_path / case, rs, albedo_ch)
        args = (p["sigma"], p["albedo"], p["emission"], p["env"] if env else None)
        kw = dict(resx=24, resy=20, n_sensors=5, density_scale=3.0, majorant_factor=2,
                  to_world=to_world)
        jb = j_scene_from_files(*args, **kw)
        tb = scene_from_files(*args, **kw, device="cpu")

        def close(a, b, what):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            assert a.shape == b.shape, (case, what, a.shape, b.shape)
            assert np.allclose(a, b, rtol=0, atol=1e-6), (case, what)
        for k in ("sigma_t", "albedo", "emission"):
            close(getattr(tb.params, k), getattr(jb.params, k), k)
            close(getattr(tb.start_from, k), getattr(jb.start_from, k), "start " + k)
        assert tb.params.albedo.shape[-1] == 3 and tb.params.emission.shape[-1] == 3
        close(tb.to_world, jb.to_world, "to_world")
        for k in ("cam_to_world", "tan_half_fov", "aspect"):
            close(getattr(tb.cameras, k), getattr(jb.cameras, k), k)
        assert (tb.film_size, tb.medium_cfg.majorant_factor, tb.medium_cfg.scale) == \
            (jb.film_size, jb.medium_cfg.majorant_factor, jb.medium_cfg.scale)
        if env:
            for k in ("data", "row_pmf", "cond_pmf", "alias_tab", "flat_data", "to_world"):
                close(getattr(tb.emitter, k), getattr(jb.emitter, k), k)
        else:
            close(tb.emitter.radiance, jb.emitter.radiance, "radiance")
            assert tb.emitter.host == ((1.0, 1.0, 1.0), tuple(tb.emitter.weight.tolist()))


@pytest.fixture(scope="module")
def smoke():
    """A 16^3 smoke in both packages: (JAX bundle, JAX scene, port scene)."""
    jb = smoke_scene(res=16, resx=16, resy=16, n_sensors=1)
    jsc, _, tsc = both_scenes(jb)
    return jb, jsc, tsc


def test_medium_rng_and_integrator_names_match_jax(smoke):
    """The medium's lookups, ``update_medium_params``, ``lane_next_2d``,
    ``zero_grads``, the compact primal and ``nerf.sample_adjoint(grads=)``
    against JAX on one medium."""
    jb, jsc, tsc = smoke
    rs = np.random.RandomState(9)
    p = rs.rand(1024, 3).astype(np.float32) * 1.2 - 0.1     # inside and outside the box
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    jm, tm = jsc.medium, tsc.medium
    assert np.allclose(albedo_at(tm, pt).numpy(), np.asarray(j_medium.albedo_at(jm, pj)),
                       rtol=0, atol=1e-6)
    assert np.array_equal(majorant_at(tm, pt).numpy(), np.asarray(j_medium.majorant_at(jm, pj)))
    assert float(global_majorant_of(tm)) == float(j_medium.global_majorant_of(jm))

    # update_medium_params: a new supergrid on the old transform
    grids = {k: np.array(getattr(jb.params, k)) for k in ("sigma_t", "albedo", "emission")}
    grids["sigma_t"] = grids["sigma_t"] * rs.rand(*grids["sigma_t"].shape).astype(np.float32) * 3
    jnew = j_scene.update_medium_params(jsc, JParams(**{k: jnp.asarray(v)
                                                       for k, v in grids.items()}),
                                        jb.medium_cfg)
    tnew = update_medium_params(tsc, MediumParams(**{k: torch.from_numpy(v)
                                                     for k, v in grids.items()}),
                                _port_cfg(jb))
    assert np.allclose(tnew.medium.majorant_grid.numpy(),
                       np.asarray(jnew.medium.majorant_grid), rtol=1e-6, atol=0)
    assert torch.equal(tnew.medium.local_to_world, tsc.medium.local_to_world)
    assert not np.array_equal(tnew.medium.majorant_grid.numpy(), tm.majorant_grid.numpy())

    # lane_next_2d, bit for bit, with a consume mask
    consume = rs.rand(4096) < 0.5
    js, ts = j_rng.make_lane_sampler(SEED, n_lanes=4096), rng.make_lane_sampler(SEED, n_lanes=4096)
    for mask in (None, consume):
        ju, js = j_rng.lane_next_2d(js, None if mask is None else jnp.asarray(mask))
        tu, ts = rng.lane_next_2d(ts, None if mask is None else torch.from_numpy(mask))
        assert tu.shape == (4096, 2)
        assert np.array_equal(tu.numpy(), np.asarray(ju))
        assert np.array_equal(ts.dim.numpy(), np.asarray(js.dim, np.int64))

    z = zero_grads(tsc.medium.params)
    for k in ("sigma_t", "albedo", "emission"):
        g = getattr(z, k)
        assert g.shape == getattr(tsc.medium.params, k).shape and not g.any()

    # the compact primal: the port's primal bounded at max_steps; JAX's
    cfg, jcfg = VolpathConfig(max_depth=4), JCfg(max_depth=4)
    (jo, jd), (o, d) = camera_rays(jb, n=1024)
    Lc, ec = volpath_flat.sample_primal_compact(cfg, tsc, o, d, SEED, schedule=(96, None))
    Lf, ef = volpath_flat.sample_primal(cfg, tsc, o, d, SEED)
    assert torch.equal(Lc, Lf) and torch.equal(ec, ef)
    Lj, _ = jax.jit(lambda o_, d_: j_flat.sample_primal_compact(jcfg, jsc, o_, d_,
                                                              jnp.uint32(SEED)))(jo, jd)
    assert_lanes_agree(np.asarray(Lj), Lc.numpy())

    # nerf.sample_adjoint(grads=): into one accumulator, twice
    ncfg = NerfConfig()
    dL = [torch.from_numpy(rs.randn(1024, 3).astype(np.float32)) for _ in range(2)]
    L, _, _ = nerf.sample_primal(ncfg, tsc, o, d, rng.make_sampler(SEED, n_lanes=1024))
    fresh = [nerf.sample_adjoint(ncfg, tsc, o, d, rng.make_sampler(SEED, n_lanes=1024), g, L)[0]
             for g in dL]
    acc = init_accum(tsc.medium)
    for g in dL:
        got, _ = nerf.sample_adjoint(ncfg, tsc, o, d, rng.make_sampler(SEED, n_lanes=1024), g, L,
                                     grads=acc)
    for k in ("sigma_t", "emission"):
        ref = getattr(fresh[0], k) + getattr(fresh[1], k)
        assert float(ref.abs().sum()) > 0
        err = float((getattr(got, k) - ref).abs().sum() / ref.abs().sum())
        assert err <= 1e-6, (k, err)
    assert got.sigma_t.data_ptr() == acc.sigma.data_ptr()


def _port_cfg(jb):
    """The JAX bundle's medium config in the port's type."""
    from uivr_tpu_torch.scene.medium import MediumConfig
    c = jb.medium_cfg
    return MediumConfig(majorant_factor=c.majorant_factor, scale=c.scale, phase_g=c.phase_g,
                        kernel_majorant_max_cells=c.kernel_majorant_max_cells)


_INDEX_SRC = r'''#define __host__
#define __device__
#include "nerf.cuh"
// The float offsets of the 8 corners of each point's cell on a (D, H, W)
// grid, as the march kernels compute them in index type Idx (nerf_cell,
// NerfMarch::strides and corner, times 4 in Idx)
template <class Idx>
static void offsets(int32_t D, int32_t H, int32_t W, const float* p, int64_t n, int64_t* out) {
  uivr::PrimalParams P{};
  P.D = D;
  P.H = H;
  P.W = W;
  uivr::NerfMarch<Idx> m;
  m.strides(P);
  for (int64_t i = 0; i < n; ++i) {
    uivr::NerfCell<Idx> c;
    uivr::nerf_cell(P, uivr::V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]}, c);
    for (int k = 0; k < 8; ++k) out[8 * i + k] = (int64_t)(m.corner(c.base, k) * 4);
  }
}
extern "C" {
void nerf_offsets32(int32_t D, int32_t H, int32_t W, const float* p, int64_t n, int64_t* out) {
  offsets<int32_t>(D, H, W, p, n, out);
}
void nerf_offsets64(int32_t D, int32_t H, int32_t W, const float* p, int64_t n, int64_t* out) {
  offsets<int64_t>(D, H, W, p, n, out);
}
int nerf_needs64(int32_t D, int32_t H, int32_t W) {
  uivr::PrimalParams P{};
  P.D = D;
  P.H = H;
  P.W = W;
  return uivr::nerf_needs_index64(P);
}
}
'''


def _offsets_numpy(shape, p):
    """numpy int64 of the same offsets: nerf_cell's float32 voxel and the
    corners' strides."""
    D, H, W = shape
    i0 = []
    for a, n in enumerate((W, H, D)):
        res = np.float32(n - 1)
        x = np.clip(p[:, a], np.float32(0), np.float32(1)) * res
        hi = np.maximum(res - np.float32(1), np.float32(0))
        i0.append(np.minimum(np.maximum(np.floor(x), np.float32(0)), hi).astype(np.int64))
    base = (i0[2] * H + i0[1]) * W + i0[0]
    sx, sy, sz = int(W > 1), (W if H > 1 else 0), (H * W if D > 1 else 0)
    k = np.arange(8)
    step = ((k & 4) > 0) * sz + ((k & 2) > 0) * sy + ((k & 1) > 0) * sx
    return (base[:, None] + step[None, :]) * 4


def test_nerf_index64_arithmetic_matches_numpy():
    """``nerf.cuh``'s corner offsets at ``Idx = int64_t`` against numpy
    int64 on grids of 2^29 and 2^31 voxels (points spread over the box, a
    third in the upper half in z, whose offsets lie above 2^30 and 2^32,
    and the box's corners), and at ``Idx = int32_t`` on 128^3; no grid is
    allocated."""
    lib = host_library(_INDEX_SRC, "nerf-index")
    i64p, f32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
    for fn in (lib.nerf_offsets32, lib.nerf_offsets64):
        fn.argtypes = [ctypes.c_int32] * 3 + [f32p, ctypes.c_int64, i64p]
        fn.restype = None
    lib.nerf_needs64.argtypes = [ctypes.c_int32] * 3
    rs = np.random.RandomState(17)
    p = rs.rand(6000, 3).astype(np.float32)
    p[:2000, 2] = p[:2000, 2] * np.float32(0.5) + np.float32(0.5)
    p = np.concatenate([p, np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                                    np.float32), np.float32([[1.2, -0.3, 0.999999]])])
    for shape, fn, needs in (((512, 1024, 1024), lib.nerf_offsets64, True),
                             ((2048, 1024, 1024), lib.nerf_offsets64, True),
                             ((128, 128, 128), lib.nerf_offsets32, False)):
        assert bool(lib.nerf_needs64(*shape)) == needs
        out = np.empty((p.shape[0], 8), np.int64)
        fn(*shape, p.ctypes.data_as(f32p), p.shape[0], out.ctypes.data_as(i64p))
        ref = _offsets_numpy(shape, p)
        assert np.array_equal(out, ref), shape
        assert ref.max() == (int(np.prod(shape)) - 1) * 4    # the box's far corner
        if needs:
            assert (ref[:2000] >= 2 ** 30).mean() > 0.9
