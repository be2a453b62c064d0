"""The finite-difference validation entry point of the port, on the CPU.

- ``validation.fd_gradients`` of both packages on one deterministic loss
  of numpy-seeded grids: forward and central differences agree;
- ``python -m uivr_tpu_torch.cli.fd --device cpu`` (tiny-cube, the albedo
  grid, 3x3 pixels at 1 spp) writes the files and summary keys the
  reference CLI writes (``adjoint_<key>.npy``, ``fd_<key>.npy``,
  ``summary.json`` with ``corr``, ``median_rel_err``, ``max_rel_err``),
  with finite values.  The reference CLI itself runs in test_cli.py.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uivr_tpu.scene.medium import MediumParams as JMediumParams
from uivr_tpu.validation import fd_gradients as j_fd_gradients
from uivr_tpu_torch.scene.medium import MediumParams
from uivr_tpu_torch.validation import fd_gradients

KEYS = ("sigma_t", "albedo", "emission")


def _grids():
    rs = np.random.RandomState(11)
    shapes = {"sigma_t": (2, 3, 2, 1), "albedo": (2, 3, 2, 3), "emission": (2, 3, 2, 3)}
    grids = {k: rs.rand(*s).astype(np.float32) for k, s in shapes.items()}
    weights = {k: rs.randn(*s) for k, s in shapes.items()}
    return grids, weights


@pytest.mark.parametrize("central", [False, True])
def test_fd_gradients_match_jax(central):
    grids, weights = _grids()

    def loss(p):
        # a smooth loss of the float32 grids, evaluated in float64 numpy
        return sum(float(np.sum(np.sin(3.0 * np.asarray(getattr(p, k), np.float64))
                                * weights[k])) for k in KEYS)

    jp = JMediumParams(**{k: jnp.asarray(v) for k, v in grids.items()})
    tp = MediumParams(**{k: torch.from_numpy(v) for k, v in grids.items()})
    ref = j_fd_gradients(loss, jp, eps=1e-2, central=central)
    got = fd_gradients(loss, tp, eps=1e-2, central=central)
    for k in KEYS:
        assert got[k].shape == grids[k].shape and got[k].dtype == np.float64
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
        # and both are derivatives of the loss: 3 cos(3 x) w
        exact = 3.0 * np.cos(3.0 * grids[k].astype(np.float64)) * weights[k]
        assert np.abs(got[k] - exact).max() < (0.05 if not central else 1e-3) * np.abs(
            weights[k]).max() * 9


def test_fd_cli_on_cpu(tmp_path):
    from uivr_tpu_torch.cli import fd as fd_cli
    out = str(tmp_path / "fd")
    # 82 plain-path renders (81 albedo entries and the base) of 9 rays each:
    # this checks the entry point's files and keys; the FD values' accuracy
    # is test_fd_gradients_match_jax's and the card's
    summary = fd_cli.main(["--scene", "tiny-cube", "--integrator", "volpathsimple-basic",
                           "--spp", "1", "--res", "3", "--eps", "0.02",
                           "--keys", "albedo", "--out", out, "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["adjoint_albedo.npy", "fd_albedo.npy", "summary.json"]
    with open(os.path.join(out, "summary.json")) as f:
        written = json.load(f)
    assert written == summary
    assert list(written) == ["albedo"]
    assert sorted(written["albedo"]) == ["corr", "max_rel_err", "median_rel_err"]
    assert all(np.isfinite(v) for v in written["albedo"].values())
    ga = np.load(os.path.join(out, "adjoint_albedo.npy"))
    gf = np.load(os.path.join(out, "fd_albedo.npy"))
    assert ga.shape == gf.shape == (3, 3, 3, 3)
    assert np.isfinite(ga).all() and np.isfinite(gf).all() and np.abs(ga).sum() > 0
