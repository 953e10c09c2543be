"""The LUT as the port's kernels read it.

The JAX package prebakes a parsed .cube into MXU matrices of several
numeric tiers (ops/prepare.prepare_lut). The port's kernels fetch table
corners directly, so they need two kinds of table:

``LutTable``: the exact f32 table and its domain, as an (N, N, N, 4)
float32 tensor on the device, RGB padded to 16 bytes so that one corner is
one 16-byte load. Kernels A and B read it.

``Coarse2Table``: the JAX package's coarse + residual decomposition of a big
LUT (odd N >= 49), ``L = U(C) + R``, at one of its ``coarse2*`` tiers.
``C = L[::2, ::2, ::2]`` is a coarse table on the (N+1)/2 grid, ``U`` its
separable linear upsample, and ``R`` an int8 residual on the fine grid
with one scale per (r index, channel) row. Kernel C and kernel B's coarse2
instantiation read it. The coarse table holds, in f32, the value the JAX
tier's coarse operand dequantises to, with the identity added back:

  coarse2f  bf16-hi of the identity-detrended table
  coarse2   int8 pair ``q1*s1 + q2*s2`` of the detrended table
  coarse2x  bf16 hi + lo pair of the detrended table

``_tri`` tiers interpolate the residual term trilinearly. Every value is
built with the JAX package's own f32 operations in its order, so the port's
tables equal the carry-across of a JAX ``PreparedLut`` bit for bit
(``Coarse2Table.from_prepared``; tests/test_torch_coarse2.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from .pixel import fdiv

COARSE2_TIERS = ("coarse2", "coarse2f", "coarse2x",
                 "coarse2_tri", "coarse2f_tri", "coarse2x_tri")


def _floats3(x) -> Tuple[float, float, float]:
    a = np.asarray(x, np.float32).reshape(3)
    return float(a[0]), float(a[1]), float(a[2])


def has_coarse2(n: int) -> bool:
    """Whether an N^3 LUT has the coarse + residual decomposition: odd
    N >= 49, the JAX package's condition (ops/prepare.py:377)."""
    return n >= 49 and n % 2 == 1


@dataclass(frozen=True, eq=False)
class LutTable:
    table: torch.Tensor                      # (N, N, N, 4) float32
    domain_min: Tuple[float, float, float]   # float32 values
    domain_max: Tuple[float, float, float]

    @property
    def size(self) -> int:
        return int(self.table.shape[0])

    @property
    def has_unit_domain(self) -> bool:
        return bool(np.allclose(self.domain_min, 0.0)
                    and np.allclose(self.domain_max, 1.0))

    @property
    def static_key(self):
        """What a render depends on besides the table values: the JAX
        package's prep_static_key reduced to size and domain (the exact
        table has no tier and no padded geometry)."""
        return (self.size, self.domain_min, self.domain_max)

    @classmethod
    def from_arrays(cls, table, domain_min, domain_max,
                    device: DeviceLike) -> "LutTable":
        t = np.asarray(table, np.float32)
        n = t.shape[0]
        if t.shape != (n, n, n, 3):
            raise ValueError(f"LUT table must be (N, N, N, 3), got {t.shape}")
        padded = np.zeros((n, n, n, 4), np.float32)
        padded[..., :3] = t
        return cls(table=torch.from_numpy(padded).to(device),
                   domain_min=_floats3(domain_min),
                   domain_max=_floats3(domain_max))

    @classmethod
    def from_prepared(cls, lut, device: DeviceLike) -> "LutTable":
        """From any object with a numpy ``table`` (N, N, N, 3) and
        ``domain_min``/``domain_max``: a parsed .cube (colorcore.cube.Lut3D)
        or the JAX package's PreparedLut, whose quantised tiers are not
        used."""
        return cls.from_arrays(lut.table, lut.domain_min, lut.domain_max,
                               device)

    from_lut3d = from_prepared

    def to(self, device: DeviceLike) -> "LutTable":
        return LutTable(self.table.to(device), self.domain_min,
                        self.domain_max)


# ---------------------------------------------------------------------------
# the coarse + residual decomposition (JAX ops/prepare.py:292-387, 737-762)
# ---------------------------------------------------------------------------

def upsample2_linear(c: torch.Tensor) -> torch.Tensor:
    """Separable linear upsample of an (M, M, M, C) grid to (2M-1, ...):
    even fine samples are the coarse points, odd ones the axis midpoints,
    axis by axis in the order of the JAX package's _upsample2_linear."""
    for axis in range(3):
        m = c.shape[axis]
        shape = list(c.shape)
        shape[axis] = 2 * m - 1
        out = torch.zeros(shape, dtype=c.dtype, device=c.device)
        even = [slice(None)] * c.dim()
        even[axis] = slice(0, None, 2)
        odd = [slice(None)] * c.dim()
        odd[axis] = slice(1, None, 2)
        out[tuple(even)] = c
        out[tuple(odd)] = 0.5 * (c.narrow(axis, 0, m - 1)
                                 + c.narrow(axis, 1, m - 1))
        c = out
    return c


def _rows_absmax(x: torch.Tensor) -> torch.Tensor:
    """(N, N, N, 3) -> (N, 1, 1, 3): the max |x| of each JAX lmat row.
    A row is (channel c, r index), its entries every (g, b)."""
    return x.abs().amax(dim=(1, 2), keepdim=True)


def _int8_rows(x: torch.Tensor):
    """Per-row symmetric int8 of x: (q, s) with s = rowmax / 127 (JAX
    _int8_single and the first plane of _int8_pair)."""
    s = fdiv(_rows_absmax(x), 127.0)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, s


def _identity_grid(m: int, device) -> torch.Tensor:
    """(M, M, M, 3) identity on the unit grid: the JAX _identity_lmat in
    table layout, with its ramp rounded as there."""
    ramp = torch.from_numpy(
        (np.arange(m, dtype=np.float32) / (m - 1)).astype(np.float32)
    ).to(device)
    r, g, b = torch.meshgrid(ramp, ramp, ramp, indexing="ij")
    return torch.stack([r, g, b], dim=-1)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 (nearest, ties to even, as ml_dtypes) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _coarse_dequant(c: torch.Tensor, mode: str) -> torch.Tensor:
    """The value the JAX coarse operand of `mode` dequantises to, for the
    (M, M, M, 3) coarse table `c` (simulate_coarse_error's three branches,
    identity-detrended)."""
    detr = c - _identity_grid(c.shape[0], c.device)
    hi = _bf16(detr)
    if mode == "coarse2f":
        return hi
    if mode == "coarse2x":
        return hi + _bf16(detr - hi)
    # coarse2: the int8 pair of _int8_pair with its scales folded by 1/254
    # and unfolded again, as _unfolded_pair_scales hands them to the kernel
    q1, s1 = _int8_rows(detr)
    q2, s2 = _int8_rows(detr - s1 * q1.to(torch.float32))
    s1u = fdiv(s1, 254.0) * 254.0
    s2u = fdiv(s2, 254.0) * 254.0
    return q1.to(torch.float32) * s1u + q2.to(torch.float32) * s2u


def _pad4(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1).contiguous()


def _quad_unpermute(mat: np.ndarray, widths: Sequence[int], n: int
                    ) -> np.ndarray:
    """Inverse of the JAX package's quad_permute: parity-quadrant columns
    back to the (rows, N*N) layout, column k*N + j."""
    out = np.zeros((mat.shape[0], n * n), mat.dtype)
    off = 0
    for q, (bs, gs) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        kk, jj = np.meshgrid(np.arange(bs, n, 2), np.arange(gs, n, 2),
                             indexing="ij")
        idx = (kk * n + jj).reshape(-1)
        out[:, idx] = mat[:, off:off + len(idx)]
        off += widths[q]
    return out


def _lmat_to_table(lmat: np.ndarray, n: int) -> np.ndarray:
    """JAX lmat rows (c*N + r, k*N + j) -> (N, N, N, 3) table [r, j, k, c]."""
    return np.ascontiguousarray(
        lmat[:3 * n].reshape(3, n, n, n).transpose(1, 3, 2, 0))


@dataclass(frozen=True, eq=False)
class Coarse2Table:
    coarse: torch.Tensor        # (M, M, M, 4) f32: dequantised coarse + identity
    resid: torch.Tensor         # (N, N, N, 4) int8 residual, 4th lane 0
    resid_scale: torch.Tensor   # (N, 4) f32: scale of (r index, channel)
    domain_min: Tuple[float, float, float]
    domain_max: Tuple[float, float, float]
    tier: str                   # one of COARSE2_TIERS

    @property
    def size(self) -> int:
        return int(self.resid.shape[0])

    @property
    def coarse_size(self) -> int:
        return int(self.coarse.shape[0])

    @property
    def resid_trilinear(self) -> bool:
        """``_tri`` tiers interpolate the residual term trilinearly."""
        return self.tier.endswith("_tri")

    @property
    def static_key(self):
        """Two tiers of one LUT are different operands."""
        return (self.size, self.domain_min, self.domain_max, self.tier)

    def resid_table(self) -> torch.Tensor:
        """The dequantised residual, (N, N, N, 4) f32: q * scale[r, c]."""
        return self.resid.to(torch.float32) * self.resid_scale[:, None, None]

    @classmethod
    def from_table(cls, table: torch.Tensor, domain_min, domain_max,
                   tier: str) -> "Coarse2Table":
        """Build from an (N, N, N, 3) f32 table on its own device, with the
        JAX package's prepare_lut operations (prepare.py:375-387)."""
        if tier not in COARSE2_TIERS:
            raise ValueError(f"unknown coarse2 tier {tier!r}")
        n = int(table.shape[0])
        if table.shape != (n, n, n, 3) or table.dtype != torch.float32:
            raise ValueError(f"LUT table must be float32 (N, N, N, 3), got "
                             f"{tuple(table.shape)} {table.dtype}")
        if not has_coarse2(n):
            raise ValueError(f"a {n}^3 LUT has no coarse2 decomposition "
                             f"(odd N >= 49)")
        c = table[::2, ::2, ::2].contiguous()
        q, s = _int8_rows(table - upsample2_linear(c))
        scale = fdiv(s, 127.0) * 127.0  # stored folded, unfolded at launch
        coarse = _coarse_dequant(c, tier.removesuffix("_tri"))
        coarse = coarse + _identity_grid(c.shape[0], c.device)
        return cls(coarse=_pad4(coarse), resid=_pad4(q),
                   resid_scale=_pad4(scale.reshape(n, 3)),
                   domain_min=_floats3(domain_min),
                   domain_max=_floats3(domain_max), tier=tier)

    @classmethod
    def from_lut_table(cls, lut: LutTable, tier: str) -> "Coarse2Table":
        """From the exact table, on its device."""
        return cls.from_table(lut.table[..., :3].contiguous(), lut.domain_min,
                              lut.domain_max, tier)

    @classmethod
    def from_prepared(cls, prep, tier: str,
                      device: DeviceLike) -> "Coarse2Table":
        """Carry a JAX PreparedLut's coarse2 operands across: ``resid_q`` and
        ``resid_scale`` for the residual, and the coarse PreparedLut's int8
        pair (``lmat_q1/q2``, ``scale_q1/q2``) or its detrended bf16 pair
        (``lmat_bf_qp``, the operand the JAX kernel reads) for the coarse
        table. Reads numpy arrays only."""
        if tier not in COARSE2_TIERS:
            raise ValueError(f"unknown coarse2 tier {tier!r}")
        if prep.coarse is None:
            raise ValueError(f"PreparedLut of size {prep.size} has no coarse2 "
                             f"decomposition")
        n, cp = prep.size, prep.coarse
        m, rows = cp.size, 3 * cp.size
        resid = _lmat_to_table(np.asarray(prep.resid_q), n)
        scale = (np.asarray(prep.resid_scale, np.float32)[:3 * n, 0]
                 * 127.0).astype(np.float32).reshape(3, n).T
        mode = tier.removesuffix("_tri")
        if mode == "coarse2":
            deq = (cp.lmat_q1[:rows].astype(np.float32)
                   * (cp.scale_q1[:rows] * 254.0)
                   + cp.lmat_q2[:rows].astype(np.float32)
                   * (cp.scale_q2[:rows] * 254.0))
        else:
            rp = cp.rows_pad
            deq = _quad_unpermute(cp.lmat_bf_qp[:rp], cp.quad_widths, m)[
                :rows].astype(np.float32)
            if mode == "coarse2x":
                deq = deq + _quad_unpermute(cp.lmat_bf_qp[rp:],
                                            cp.quad_widths, m)[
                    :rows].astype(np.float32)
        coarse = torch.from_numpy(_lmat_to_table(deq, m)).to(device)
        coarse = coarse + _identity_grid(m, coarse.device)
        return cls(coarse=_pad4(coarse),
                   resid=_pad4(torch.from_numpy(resid).to(device)),
                   resid_scale=_pad4(torch.from_numpy(
                       np.ascontiguousarray(scale)).to(device)),
                   domain_min=_floats3(prep.domain_min),
                   domain_max=_floats3(prep.domain_max), tier=tier)

    def to(self, device: DeviceLike) -> "Coarse2Table":
        return Coarse2Table(self.coarse.to(device), self.resid.to(device),
                            self.resid_scale.to(device), self.domain_min,
                            self.domain_max, self.tier)
