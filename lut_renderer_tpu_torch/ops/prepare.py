"""The LUT as the port's kernels read it.

The JAX package prebakes a parsed .cube into MXU matrices of several
numeric tiers (ops/prepare.prepare_lut). The port's kernels fetch table
corners directly, so all they need is the f32 table and its domain:
``LutTable`` holds the table as an (N, N, N, 4) float32 tensor on the
device, RGB padded to 16 bytes so that one corner is one 16-byte load.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike


def _floats3(x) -> Tuple[float, float, float]:
    a = np.asarray(x, np.float32).reshape(3)
    return float(a[0]), float(a[1]), float(a[2])


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
        package's prep_static_key reduced to size and domain (there are no
        tiers or padded geometries here)."""
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
    def from_lut3d(cls, lut, device: DeviceLike) -> "LutTable":
        """From a parsed .cube (colorcore.cube.Lut3D), skipping the JAX
        package's MXU prebake."""
        return cls.from_arrays(lut.table, lut.domain_min, lut.domain_max,
                               device)

    @classmethod
    def from_prepared(cls, prep, device: DeviceLike) -> "LutTable":
        """From the JAX package's PreparedLut (its numpy ``table`` and
        domain; the quantised tiers are not used)."""
        return cls.from_arrays(prep.table, prep.domain_min, prep.domain_max,
                               device)

    def to(self, device: DeviceLike) -> "LutTable":
        return LutTable(self.table.to(device), self.domain_min,
                        self.domain_max)
