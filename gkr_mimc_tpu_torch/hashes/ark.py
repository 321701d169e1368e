"""Round constants as field ints (the Arks, and the Poseidon MDS generators
XARR and YARR) and the Arks as Montgomery limb rows."""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields import fr
from ..fields.bn254 import P
from .ark_data import ARKS, XARR, YARR

ARKS_INT = [a % P for a in ARKS]
XARR_INT = [a % P for a in XARR]
YARR_INT = [a % P for a in YARR]


@lru_cache(maxsize=None)
def _arks_rows(n: int, device: torch.device) -> torch.Tensor:
    return fr.encode_mont_ints(ARKS_INT[:n], device).T.contiguous()


def arks_mont(n: int, device=None) -> torch.Tensor:
    """First n Arks in Montgomery form as rows, shape (n, 8) int32."""
    return _arks_rows(n, torch.device(device or "cpu"))
