"""The port's native host helpers (``uivr_tpu_torch/native``) against their
Python versions and the JAX package's native library, on the CPU.

- alias tables of pmfs with zeros, with one spike and of 2^16 texels: bit
  for bit the port's Python builder and ``uivr_tpu.native``;
- the EXR ZIP predictors: byte for byte the port's Python filters and
  JAX's, round trips, and a ZIP EXR written and read through them;
- HDR scanlines: new-style RLE, flat, and old-style long runs decode as the
  port's Python reader and ``uivr_tpu.core.hdr_io`` do; malformed input is
  left to the Python reader, which raises;
- an XML scene with a stand-in map loads through the native path
  (``CALLS``), and through the Python path, to the same tables, where no
  g++ is found; a build that fails raises with the compiler's output.
"""
import numpy as np
import pytest

import uivr_tpu.native as j_native
from test_xml_scene import _XML
from uivr_tpu.core import exr_io as j_exr_io
from uivr_tpu.core import hdr_io as j_hdr_io
from uivr_tpu.core.vol_io import write_vol
from uivr_tpu_torch import native
from uivr_tpu_torch.config.xml_scene import load_xml_scene
from uivr_tpu_torch.core import exr_io, hdr_io
from uivr_tpu_torch.scene.emitters import _build_alias_python

HEAD = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
VARIABLES = {"medium_filename": "density.vol"}


def _pmfs():
    rs = np.random.RandomState(7)
    big = rs.rand(1 << 16) ** 3
    zeros = rs.rand(4096)
    zeros[rs.rand(4096) < 0.4] = 0.0
    spike = np.full(1024, 1e-9)
    spike[321] = 1.0
    for p in (big, zeros, spike, np.ones(1)):
        yield p / p.sum()


def test_alias_tables_match_python_and_jax():
    for pmf in _pmfs():
        alias, prob = native.build_alias_table(pmf)
        a_py, p_py = _build_alias_python(pmf)
        a_j, p_j = j_native.build_alias_table(pmf)
        assert alias.dtype == a_py.dtype == np.int32 and prob.dtype == p_py.dtype == np.float32
        assert np.array_equal(alias, a_py) and np.array_equal(prob, p_py)
        assert np.array_equal(alias, a_j) and np.array_equal(prob, p_j)


def test_exr_predictors_match_python_and_jax(tmp_path):
    rs = np.random.RandomState(2)
    for data in (rs.bytes(10001), rs.bytes(4096), b"\x07"):
        enc = native.exr_zip_predict(data)
        assert enc == exr_io._zip_predict_python(data) == j_exr_io._zip_predict(data)
        dec = native.exr_zip_unpredict(enc)
        assert dec == data == exr_io._zip_unpredict_python(enc) == j_exr_io._zip_unpredict(enc)
    # empty input (the reference's library reads a byte past it: not called)
    assert native.exr_zip_predict(b"") == native.exr_zip_unpredict(b"") == b""
    img = np.repeat(np.linspace(0.0, 2.0, 37 * 23, dtype=np.float32).reshape(37, 23, 1), 3, -1)
    before = dict(native.CALLS)
    exr_io.write_exr(str(tmp_path / "a.exr"), img)
    np.testing.assert_array_equal(exr_io.read_exr(str(tmp_path / "a.exr")), img)
    np.testing.assert_array_equal(j_exr_io.read_exr(str(tmp_path / "a.exr")), img)
    assert native.CALLS["native"] - before["native"] == 2 * 3     # 3 ZIP chunks each way
    assert native.CALLS["python"] == before["python"]


def _hdr_files(tmp_path):
    """Flat, new-style RLE and old-style long-run files (the inputs of
    tests/test_native_and_ckpt.py)."""
    rs = np.random.RandomState(5)
    p_flat = tmp_path / "flat.hdr"
    hdr_io.write_hdr(str(p_flat), (rs.rand(33, 64, 3).astype(np.float32) * 4) ** 2)
    W = 64
    sl = bytes([2, 2, W >> 8, W & 255])
    for c, v in enumerate([128, 64, 32, 140]):
        sl += (bytes([128 + 32, v]) + bytes([16]) + bytes(range(c, c + 16))
               + bytes([128 + 16, v + 1]))
    p_rle = tmp_path / "rle.hdr"
    p_rle.write_bytes(HEAD + b"-Y 2 +X 64\n" + sl * 2)
    px = bytes([100, 120, 140, 136])
    p_old = tmp_path / "oldrle.hdr"
    p_old.write_bytes(HEAD + b"-Y 2 +X 556\n"
                      + (px + bytes([1, 1, 1, 43]) + bytes([1, 1, 1, 2])) * 2)
    return p_flat, p_rle, p_old


def test_hdr_decoding_matches_python_and_jax(tmp_path, monkeypatch):
    files = _hdr_files(tmp_path)
    for p in files:
        data = p.read_bytes()
        pos = data.index(b"\n", data.index(b"\n\n") + 2) + 1
        H, W = (int(x) for x in data[len(HEAD):pos].split()[1::2])
        rgbe = native.hdr_decode_scanlines(data[pos:], W, H)
        assert rgbe is not None and rgbe.shape == (H, W, 4)
        np.testing.assert_array_equal(
            rgbe, hdr_io._decode_scanlines_python(np.frombuffer(data, np.uint8, offset=pos), W, H))
        np.testing.assert_array_equal(hdr_io.read_hdr(str(p)), j_hdr_io.read_hdr(str(p)))
    np.testing.assert_array_equal(hdr_io.read_hdr(str(files[2]))[0, -1],
                                  hdr_io.read_hdr(str(files[2]))[0, 0])
    # malformed: a cut file, and a run past the scanline's end; the native
    # decoder returns None, and the Python reader then does what JAX's does
    # (raise on the first, write the run's start on the second)
    bad = tmp_path / "bad.hdr"
    good_rle = files[1].read_bytes()
    for payload, raises in ((good_rle[:-40], True),
                            (good_rle.replace(bytes([144, 129]), bytes([188, 129])), False)):
        bad.write_bytes(payload)
        assert native.hdr_decode_scanlines(payload[len(HEAD) + 11:], 64, 2) is None
        python_calls = native.CALLS["python"]
        if raises:
            with pytest.raises(IndexError):
                hdr_io.read_hdr(str(bad))
            with pytest.raises(IndexError):
                j_hdr_io.read_hdr(str(bad))
        else:
            np.testing.assert_array_equal(hdr_io.read_hdr(str(bad)), j_hdr_io.read_hdr(str(bad)))
        assert native.CALLS["python"] == python_calls + 1


def test_xml_scene_loads_through_the_native_path(tmp_path, monkeypatch):
    rs = np.random.RandomState(3)
    write_vol(str(tmp_path / "density.vol"), rs.rand(12, 10, 8, 1).astype(np.float32))
    write_vol(str(tmp_path / "albedo.vol"), rs.rand(12, 10, 8, 3).astype(np.float32))
    j_hdr_io.write_hdr(str(tmp_path / "sky.hdr"), rs.rand(16, 32, 3).astype(np.float32) ** 2)
    (tmp_path / "scene.xml").write_text(_XML)
    before = dict(native.CALLS)
    nat = load_xml_scene(str(tmp_path / "scene.xml"), VARIABLES, device="cpu")
    assert native.CALLS["native"] - before["native"] == 2       # the map, its alias table
    assert native.CALLS["python"] == before["python"]
    # no g++ on the PATH: the Python versions, to the same tables
    monkeypatch.setattr(native, "_lib", None)
    with monkeypatch.context() as m:
        m.setattr(native.shutil, "which", lambda name: None)
        py = load_xml_scene(str(tmp_path / "scene.xml"), VARIABLES, device="cpu")
    assert native.CALLS["python"] - before["python"] == 2
    for k in ("data", "alias_tab", "row_pmf", "cond_pmf"):
        assert np.array_equal(getattr(nat.emitter, k).numpy(), getattr(py.emitter, k).numpy())
    # a build that fails raises, with the compiler's output
    broken = tmp_path / "uivr_native.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*not C\\+\\+"):
        native.build_alias_table(np.ones(4) / 4)
    assert not list((tmp_path / "build").glob("*.so"))
