"""Emitters: constant background and importance-sampled lat-long envmap.

Port of ``uivr_tpu/scene/emitters.py``.  Sampling returns (direction,
solid-angle pdf, radiance/pdf).  Envmap sampling uses a Walker alias table
over the flattened H*W texels (one table row and one radiance row per
sample).  A map above 8192 texels also carries the reference's coarse
``nee`` proxy (an area-weighted downsample to at most 2048 texels with its
own tables): the walking kernels sample NEE directions from the proxy and
multiply in the full-resolution radiance of the texel the direction lands
in (deferred-radiance NEE, K3b; :func:`sample_deferred`), and weigh escapes
with the proxy's pdf.  The plain twin does the same in its deferred mode.

As the reference's XLA build does, a division by a constant is a
multiplication by its float32 reciprocal, and fused multiply-adds sit where
that build fuses them (see ``core/fmath.py``); the kernel repeats both.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import fmath
from ..core.aabb import transform_dirs
from ..core.fmath import fma

_TWO_PI = 2.0 * math.pi
_INV_FOUR_PI = 1.0 / (4.0 * math.pi)
_TWO_PI_SQ = 2.0 * math.pi * math.pi
_INV_TWO_PI = 1.0 / _TWO_PI
_INV_PI = 1.0 / math.pi


def _square_to_uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[:, 0]
    r = fmath.sqrt(torch.clamp(fma(-z, z, 1.0), min=0.0))
    phi = _TWO_PI * u[:, 1]
    return torch.stack([r * fmath.cos(phi), z, r * fmath.sin(phi)], dim=-1)


class ConstantEmitter(NamedTuple):
    radiance: torch.Tensor  # (3,) float32

    @property
    def weight(self) -> torch.Tensor:
        """radiance / pdf of a uniform sphere sample (3,)."""
        return self.radiance / torch.full_like(self.radiance, _INV_FOUR_PI)

    def eval(self, d: torch.Tensor) -> torch.Tensor:
        return self.radiance.expand(d.shape[:-1] + (3,))

    def pdf_direction(self, d: torch.Tensor) -> torch.Tensor:
        return torch.full(d.shape[:-1], _INV_FOUR_PI, dtype=d.dtype,
                          device=d.device)

    def sample_direction(self, u2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        d = _square_to_uniform_sphere(u2)
        pdf = torch.full(u2.shape[:-1], _INV_FOUR_PI, dtype=u2.dtype,
                         device=u2.device)
        return d, pdf, self.weight.expand(d.shape[:-1] + (3,))


class EnvmapEmitter(NamedTuple):
    """Lat-long environment map (y-up: v = theta/pi from +y,
    u = atan2(d.z, d.x)/2pi wrapped) with alias-table sampling.
    ``to_world`` rotates emitter-local directions into world space."""
    data: torch.Tensor       # (H, W, 3)
    row_pmf: torch.Tensor    # (H,)
    cond_pmf: torch.Tensor   # (H, W)
    # per texel [alias_p, alias_idx (as float), pmf_self, pmf_alias]
    alias_tab: torch.Tensor  # (H*W, 4)
    flat_data: torch.Tensor  # (H*W, 3) radiance rows
    to_world: torch.Tensor   # (3, 3)
    # coarse sampling proxy of a map above 8192 texels (make_envmap), or None
    nee: Optional["EnvmapEmitter"] = None

    def _dir_to_uv(self, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dl = transform_dirs(self.to_world.T, d)   # world -> local: d @ M
        u = fmath.atan2(dl[..., 2], dl[..., 0]) * _INV_TWO_PI
        u = torch.remainder(u, 1.0)
        v = fmath.acos(torch.clamp(dl[..., 1], -1.0, 1.0)) * _INV_PI
        return u, v

    def _uv_to_dir(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        phi = u * _TWO_PI
        theta = v * math.pi
        st = fmath.sin(theta)
        dl = torch.stack([st * fmath.cos(phi), fmath.cos(theta),
                          st * fmath.sin(phi)], dim=-1)
        return transform_dirs(self.to_world, dl)   # dl @ M.T

    def eval(self, d: torch.Tensor) -> torch.Tensor:
        """Bilinear radiance lookup in direction ``d`` (n, 3)."""
        H, W, _ = self.data.shape
        u, v = self._dir_to_uv(d)
        x = u * W - 0.5
        y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
        x0 = torch.floor(x)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0i = torch.remainder(x0.to(torch.int64), W)
        x1i = torch.remainder(x0i + 1, W)
        y1 = torch.clamp(y0 + 1, max=H - 1)
        c00 = self.data[y0, x0i]
        c01 = self.data[y0, x1i]
        c10 = self.data[y1, x0i]
        c11 = self.data[y1, x1i]
        top = fma(c00, 1 - fx, c01 * fx)
        bottom = fma(c10, 1 - fx, c11 * fx)
        return fma(top, 1 - fy, bottom * fy)

    def pdf_direction(self, d: torch.Tensor) -> torch.Tensor:
        """Solid-angle pdf of ``sample_direction`` for MIS."""
        H, W, _ = self.data.shape
        u, v = self._dir_to_uv(d)
        col = torch.clamp((u * W).to(torch.int64), 0, W - 1)
        row = torch.clamp((v * H).to(torch.int64), 0, H - 1)
        p_uv = self.row_pmf[row] * H * self.cond_pmf[row, col] * W
        sin_theta = fmath.sin(torch.clamp(v, 1e-4, 1 - 1e-4) * math.pi)
        return p_uv / (_TWO_PI_SQ * sin_theta)

    def sample_uv(self, u2: torch.Tensor):
        """Alias-table sample of a point (u, v) of the map: returns u, v,
        the solid-angle pdf and the texel it lies in."""
        H, W, _ = self.data.shape
        N = H * W
        scaled = u2[:, 0] * N
        slot = torch.clamp(scaled.to(torch.int64), 0, N - 1)
        frac = scaled - slot.to(u2.dtype)
        tab = self.alias_tab[slot]
        a_p, a_idx, pmf_self, pmf_alias = tab.unbind(-1)
        keep = frac < a_p
        texel = torch.where(keep, slot, a_idx.to(torch.int64))
        pmf = torch.where(keep, pmf_self, pmf_alias)
        row = torch.div(texel, W, rounding_mode="floor")
        col = texel - row * W
        u = (col.to(u2.dtype) + u2[:, 1]) * (1.0 / W)
        # the sub-texel fraction, rescaled, jitters v
        dv = torch.where(keep, frac / torch.clamp(a_p, min=1e-20),
                         (frac - a_p) / torch.clamp(1.0 - a_p, min=1e-20))
        v = (row.to(u2.dtype) + torch.clamp(dv, 0.0, 1.0 - 1e-6)) * (1.0 / H)
        sin_theta = fmath.sin(torch.clamp(v, 1e-4, 1 - 1e-4) * math.pi)
        pdf = (pmf * N) / (_TWO_PI_SQ * sin_theta)
        return u, v, pdf, texel

    def sample_direction(self, u2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Alias-table direction sample; returns (d, pdf, radiance/pdf)."""
        u, v, pdf, texel = self.sample_uv(u2)
        d = self._uv_to_dir(u, v)
        val = self.flat_data[texel]
        weight = torch.where(pdf[:, None] > 0,
                             val / torch.clamp(pdf, min=1e-20)[:, None], 0.0)
        return d, pdf, weight


def sample_deferred(e: EnvmapEmitter, u2: torch.Tensor):
    """Deferred-radiance NEE (K3b; the reference kernel's ``em_fh`` mode):
    the direction is sampled from the coarse proxy ``e.nee``, and the
    radiance is that of the full-resolution texel the direction lands in,
    ``min(int(v fh), fh-1) fw + min(int(u fw), fw-1)``.  Returns (d, proxy
    pdf, 1/pdf (0 where the pdf is 0), full-resolution radiance): the
    caller multiplies its weight by 1/pdf, then by the radiance."""
    fh, fw, _ = e.data.shape
    u, v, pdf, _ = e.nee.sample_uv(u2)
    d = e.nee._uv_to_dir(u, v)
    inv_pdf = torch.where(pdf > 0, 1.0 / torch.clamp(pdf, min=1e-20), 0.0)
    col = torch.clamp((u * fw).to(torch.int64), max=fw - 1)
    row = torch.clamp((v * fh).to(torch.int64), max=fh - 1)
    return d, pdf, inv_pdf, e.flat_data[row * fw + col]


def _build_alias(pmf: np.ndarray):
    """Walker/Vose alias table (host side, O(N)).  Pops in the same order
    as the reference's native builder, so the tables are identical; the
    float64 arithmetic runs on Python floats."""
    N = pmf.size
    scaled = (pmf * N).tolist()
    alias = np.arange(N, dtype=np.int32)
    prob = np.ones(N, dtype=np.float64)
    small = [i for i in range(N) if scaled[i] < 1.0]
    large = [i for i in range(N) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return alias, prob.astype(np.float32)


def _area_downsample(data: np.ndarray, max_texels: int) -> np.ndarray:
    """Exact area-weighted mean downsample of (H, W, 3) to at most
    ``max_texels`` texels (aspect kept; the coarse and fine cell
    boundaries need not align), in float64: rows, then columns."""
    H, W, _ = data.shape
    k = 1
    while -(-H // k) * -(-W // k) > max_texels:
        k += 1
    Hc, Wc = -(-H // k), -(-W // k)

    def overlap(nc, nf):
        # A[i, j] = |[i/nc,(i+1)/nc] ∩ [j/nf,(j+1)/nf]| * nc  (rows sum to 1)
        i = np.arange(nc, dtype=np.float64)[:, None]
        j = np.arange(nf, dtype=np.float64)[None, :]
        lo = np.maximum(i / nc, j / nf)
        hi = np.minimum((i + 1) / nc, (j + 1) / nf)
        return (np.maximum(hi - lo, 0.0) * nc).astype(np.float64)

    rows = np.tensordot(overlap(Hc, H), data.astype(np.float64), axes=(1, 0))
    out = np.einsum("kw,iwc->ikc", overlap(Wc, W), rows)
    return out.astype(np.float32)


def nee_proxy(data: np.ndarray, to_world: np.ndarray, nee_max_texels: int = 8192,
              device=None) -> Optional[EnvmapEmitter]:
    """The coarse NEE proxy of a (H, W, 3) map above ``nee_max_texels``
    texels (``UIVR_NEE_COARSE_TEX`` texels at most, default 2048), or None."""
    H, W, _ = data.shape
    if not nee_max_texels or H * W <= nee_max_texels:
        return None
    tgt = int(os.environ.get("UIVR_NEE_COARSE_TEX", 2048))
    return make_envmap(_area_downsample(data, tgt), to_world, nee_max_texels=0,
                       device=device)


def make_envmap(data: np.ndarray, to_world: np.ndarray = None,
                nee_max_texels: int = 8192, device=None) -> EnvmapEmitter:
    """Build the pmf and alias tables of a (H, W, 3) radiance map.  A map
    above ``nee_max_texels`` texels also gets the coarse ``nee`` proxy
    (:func:`nee_proxy`); ``nee_max_texels=0`` builds none, which turns K3b
    off."""
    data = np.asarray(data, np.float32)
    H, W, _ = data.shape
    lum = data @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    sin_theta = np.sin((np.arange(H) + 0.5) / H * np.pi).astype(np.float32)
    w = np.maximum(lum, 0.0) * sin_theta[:, None] + 1e-12
    row_w = w.sum(axis=1)
    row_pmf = (row_w / row_w.sum()).astype(np.float32)
    cond_pmf = (w / row_w[:, None]).astype(np.float32)
    texel_pmf = (row_pmf[:, None] * cond_pmf).reshape(-1).astype(np.float64)
    texel_pmf /= texel_pmf.sum()
    alias, prob = _build_alias(texel_pmf)
    tp32 = texel_pmf.astype(np.float32)
    alias_tab = np.stack([prob, alias.astype(np.float32), tp32, tp32[alias]],
                         axis=-1).astype(np.float32)
    if to_world is None:
        to_world = np.eye(3, dtype=np.float32)
    nee = nee_proxy(data, to_world, nee_max_texels, device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    data_t = t(data)
    return EnvmapEmitter(data=data_t, row_pmf=t(row_pmf), cond_pmf=t(cond_pmf),
                         alias_tab=t(alias_tab), flat_data=data_t.reshape(-1, 3),
                         to_world=t(to_world), nee=nee)
