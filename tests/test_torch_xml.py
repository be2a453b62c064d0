"""The XML scene path of the port against the JAX package, on the CPU.

- ``core/hdr_io``: the writer's files byte for byte, and both readers on
  each other's files and on run-length scanlines, bit for bit;
- ``config/xml_scene.load_xml_scene`` on the XML of
  ``tests/test_xml_scene.py`` and on a copy of
  ``scenes/janga-smoke/janga-smoke.xml`` with tiny assets under the
  preset's file names (a mixed-resolution albedo, a sky above 8192 texels
  so the envmap gets its coarse NEE proxy): cameras, transforms, grids,
  emitter tables and medium config equal to 1e-6;
- the registry's ``build()`` / ``build_ref()`` through ``UIVR_SCENE_DIR``,
  and the reference's refusals for surface reference scenes.
"""
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from test_xml_scene import _XML
from uivr_tpu.config import get_scene_config as j_get_scene_config
from uivr_tpu.config.scenes import procedural_sky
from uivr_tpu.config.xml_scene import load_xml_scene as j_load_xml_scene
from uivr_tpu.core import hdr_io as jhdr
from uivr_tpu.core.vol_io import write_vol
from uivr_tpu_torch.config import get_scene_config
from uivr_tpu_torch.config.xml_scene import load_xml_scene
from uivr_tpu_torch.core import hdr_io

REPO = Path(__file__).resolve().parents[1]
START = {"medium1.sigma_t.data": 0.002, "medium1.albedo.data": 0.6,
         "medium1.emission.data": 0.005}
# the janga-smoke preset's asset names, at tiny shapes
JANGA_ASSETS = {"volumes/janga-smoke-264-136-136.vol": (10, 14, 10, 1),
                "volumes/albedo-noise-256-128-128.vol": (6, 8, 6, 3)}
JANGA_SKY = ("textures/gamrig_2k.hdr", (64, 192))     # 12,288 texels


def _rle_scanline(row: np.ndarray) -> bytes:
    """A new-style run-length scanline of (W, 4) uint8: runs of >= 3 equal
    bytes as runs, the rest as literal dumps."""
    out = bytearray([2, 2, row.shape[0] >> 8, row.shape[0] & 255])
    for c in range(4):
        v = row[:, c].tolist()
        x = 0
        while x < len(v):
            n = 1
            while x + n < len(v) and v[x + n] == v[x] and n < 127:
                n += 1
            if n >= 3:
                out += bytes([128 + n, v[x]])
                x += n
            else:
                m = 0
                while x + m < len(v) and m < 128 and not (
                        x + m + 2 < len(v) and v[x + m] == v[x + m + 1] == v[x + m + 2]):
                    m += 1
                out += bytes([m]) + bytes(v[x:x + m])
                x += m
    return bytes(out)


def test_hdr_codec_matches_jax(tmp_path):
    rs = np.random.RandomState(4)
    img = (rs.rand(9, 24, 3).astype(np.float32) ** 4) * 50.0
    img[0, :5] = 0.0
    img[3, 2] = [1e-40, 0.0, 0.0]
    mine, ref = tmp_path / "port.hdr", tmp_path / "jax.hdr"
    hdr_io.write_hdr(str(mine), img)
    jhdr.write_hdr(str(ref), img)
    assert mine.read_bytes() == ref.read_bytes()
    np.testing.assert_array_equal(hdr_io.read_hdr(str(ref)), jhdr.read_hdr(str(mine)))
    np.testing.assert_array_equal(hdr_io.read_hdr(str(mine)), jhdr.read_hdr(str(ref)))
    # run-length scanlines (rows 0, 3, 6), flat scanlines with an old-style
    # run marker (rows 1, 4, 7) and plain flat scanlines
    rgbe = np.frombuffer(ref.read_bytes()[-9 * 24 * 4:], np.uint8).reshape(9, 24, 4).copy()
    rgbe[:, 8:20] = rgbe[:, 7:8]
    rows = []
    for y in range(9):
        if y % 3 == 0:
            rows.append(_rle_scanline(rgbe[y]))
        elif y % 3 == 1:     # pixel 7, then a marker repeating it 12 times
            rows.append(rgbe[y, :8].tobytes() + bytes([1, 1, 1, 12]) + rgbe[y, 20:].tobytes())
        else:
            rows.append(rgbe[y].tobytes())
    path = tmp_path / "rle.hdr"
    path.write_bytes(ref.read_bytes()[:-9 * 24 * 4] + b"".join(rows))
    got = hdr_io.read_hdr(str(path))
    np.testing.assert_array_equal(got, jhdr.read_hdr(str(path)))
    np.testing.assert_array_equal(got, jhdr._decode_rgbe(rgbe))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The XML of tests/test_xml_scene.py with its assets, and a scene
    directory holding a copy of janga-smoke's XML with tiny assets."""
    d = tmp_path_factory.mktemp("xmlscene")
    rs = np.random.RandomState(3)
    write_vol(str(d / "density.vol"), rs.rand(12, 10, 8, 1).astype(np.float32))
    write_vol(str(d / "albedo.vol"), rs.rand(12, 10, 8, 3).astype(np.float32))
    jhdr.write_hdr(str(d / "sky.hdr"), rs.rand(16, 32, 3).astype(np.float32) ** 2 + 0.05)
    (d / "scene.xml").write_text(_XML)
    root = tmp_path_factory.mktemp("scenes")
    janga = root / "janga-smoke"
    (janga / "volumes").mkdir(parents=True)
    (janga / "textures").mkdir()
    shutil.copy(REPO / "scenes" / "janga-smoke" / "janga-smoke.xml", janga)
    for name, shape in JANGA_ASSETS.items():
        write_vol(str(janga / name), rs.rand(*shape).astype(np.float32))
    jhdr.write_hdr(str(janga / JANGA_SKY[0]), procedural_sky(*JANGA_SKY[1]))
    return d, root


def _assert_bundles_equal(jb, tb):
    a = np.asarray
    assert tuple(tb.film_size) == tuple(jb.film_size)
    assert tb.max_depth == jb.max_depth and tb.max_density == jb.max_density
    assert tb.sensors == jb.sensors and tb.preview_sensors == jb.preview_sensors
    assert tb.medium_cfg.majorant_factor == jb.medium_cfg.majorant_factor
    assert tb.medium_cfg.scale == jb.medium_cfg.scale
    assert tb.medium_cfg.phase_g == jb.medium_cfg.phase_g
    np.testing.assert_allclose(tb.to_world, a(jb.to_world), rtol=0, atol=1e-6)
    for f in ("cam_to_world", "tan_half_fov", "aspect"):
        np.testing.assert_allclose(getattr(tb.cameras, f).numpy(), a(getattr(jb.cameras, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    grids = [(tb.params, jb.params)]
    if jb.start_from is not None:
        grids.append((tb.start_from, jb.start_from))
    else:
        assert tb.start_from is None
    for t, j in grids:
        for f in ("sigma_t", "albedo", "emission"):
            assert tuple(getattr(t, f).shape) == tuple(getattr(j, f).shape), f
            np.testing.assert_allclose(getattr(t, f).numpy(), a(getattr(j, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    te, je = tb.emitter, jb.emitter
    pairs = [(te, je)] + ([(te.nee, je.nee)] if je.nee is not None else [])
    assert (te.nee is None) == (je.nee is None)
    for t, j in pairs:
        for f in ("data", "row_pmf", "cond_pmf", "alias_tab", "flat_data", "to_world"):
            np.testing.assert_allclose(getattr(t, f).numpy(), a(getattr(j, f)),
                                       rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("which", ["test-xml", "janga-smoke"])
def test_load_xml_scene_matches_jax(dirs, which):
    d, root = dirs
    if which == "test-xml":
        path, variables = str(d / "scene.xml"), {"medium_filename": "density.vol"}
    else:
        path = str(root / "janga-smoke" / "janga-smoke.xml")
        variables = get_scene_config("janga-smoke").scene_vars
    jb = j_load_xml_scene(path, variables=variables, start_from_value=START)
    tb = load_xml_scene(path, variables=variables, start_from_value=START, device="cpu")
    _assert_bundles_equal(jb, tb)
    if which == "janga-smoke":
        assert tb.cameras.n_sensors == 64 and tb.emitter.nee is not None
        assert tb.params.albedo.shape == tb.params.sigma_t.shape[:3] + (3,)


def test_registry_builds_xml_presets(dirs, monkeypatch):
    _, root = dirs
    monkeypatch.setenv("UIVR_SCENE_DIR", str(root))
    for build in ("build", "build_ref"):
        jb = getattr(j_get_scene_config("janga-smoke"), build)()
        tb = getattr(get_scene_config("janga-smoke"), build)(device="cpu")
        _assert_bundles_equal(jb, tb)
        assert len(tb.sensors) == 62 and tb.cameras.n_sensors == 64
    # a surface reference scene: missing while its training scene exists,
    # then present; both packages refuse alike
    astro = root / "astronaut-rotated"
    astro.mkdir()
    shutil.copy(root / "janga-smoke" / "janga-smoke.xml", astro / "astronaut-rotated.xml")
    vars_ = get_scene_config("astronaut-rotated").scene_vars
    for k, v in vars_.items():
        if k.endswith("_filename"):
            (astro / v).parent.mkdir(exist_ok=True)
            shutil.copy(root / "janga-smoke" / (JANGA_SKY[0] if v.endswith(("hdr", "exr"))
                                                else next(iter(JANGA_ASSETS))), astro / v)
    for exc in (FileNotFoundError, NotImplementedError):
        with pytest.raises(exc):
            j_get_scene_config("astronaut-rotated").build_ref()
        with pytest.raises(exc):
            get_scene_config("astronaut-rotated").build_ref(device="cpu")
        (astro / "astronaut-rotated-ref.xml").write_text("<scene/>")
    # a checkout holds the XML without its assets: the procedural stand-in
    monkeypatch.setenv("UIVR_SCENE_DIR", str(REPO / "scenes"))
    preset = get_scene_config("janga-smoke")
    assert os.path.exists(REPO / "scenes" / preset.scene_xml)
    assert not preset._xml_ready(preset.scene_xml, preset.scene_vars)
