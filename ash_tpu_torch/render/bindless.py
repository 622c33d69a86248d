"""Bindless texture manager: the host side of the flat texture pool (port
of ash_tpu/render/bindless.py).

`add_sampled_image` returns a monotonically increasing index that is never
recycled; the default capacity is 4096, the reference's. Registration keeps
the host mip pyramid, and `pool()` packs every texture into the flat pool
that ops/texture_sample.py samples, on the manager's device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.texture import TextureData, mip_chain
from ..device import resolve_device
from ..errors import ResourceCreationError
from ..ops.texture_sample import TexturePool, build_pool

DEFAULT_CAPACITY = 4096
MAX_BINDLESS_RESOURCES = 128 * 1024

_BYTES_PER_TEXEL = 8  # bfloat16 RGBA


class BindlessTextureManager:
    """Monotonic texture registry -> flat device pool.

    With `budget_bytes` set this is a streaming pool with mip residency:
    when every mip does not fit the budget, the finest levels of the
    largest textures are demoted (not resident) until they do, and sampling
    clamps to the finest resident mip. The texel arena has the budget's
    fixed size, so a change of residency (`request_residency`, or a
    demotion) rewrites values without changing shapes.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 budget_bytes: Optional[int] = None, device="cuda"):
        if capacity > MAX_BINDLESS_RESOURCES:
            raise ResourceCreationError(
                f"capacity {capacity} exceeds pool max {MAX_BINDLESS_RESOURCES}"
            )
        self.capacity = capacity
        self.budget_bytes = budget_bytes
        self.device = resolve_device(device)
        self._pyramids: List[List[np.ndarray]] = []
        self._requested: List[int] = []  # wanted min_level per texture
        self._resident: List[int] = []  # actual, after the budget fit
        self._prio: List[int] = []  # recency of explicit requests
        self._prio_counter = 0
        self._pool: Optional[TexturePool] = None
        self._dirty = True
        self.restream_count = 0
        # Bumped whenever the pool's values may change (a new texture, a
        # restream); caches of what samples the pool (the renderer's
        # alpha-tested shadow map) key on it.
        self.version = 0

    def __len__(self) -> int:
        return len(self._pyramids)

    def add_sampled_image(self, data: TextureData) -> int:
        """Register a texture; returns its bindless index (never recycled)."""
        if len(self._pyramids) >= self.capacity:
            raise ResourceCreationError(
                f"bindless pool full ({self.capacity} textures)"
            )
        idx = len(self._pyramids)
        self._pyramids.append(mip_chain(None, data.to_linear_f32()))
        self._requested.append(0)
        self._prio.append(0)
        self._dirty = True
        self.version += 1
        return idx

    def request_residency(self, index: int, min_level: int) -> None:
        """Ask for texture `index`'s mips >= min_level to be resident (0 =
        the full chain). Recently requested textures are demoted last when
        the budget fit must evict; without a budget this only records the
        wish."""
        levels = len(self._pyramids[index])
        self._requested[index] = int(np.clip(min_level, 0, levels - 1))
        self._prio_counter += 1
        self._prio[index] = self._prio_counter
        self._dirty = True
        self.version += 1

    # -- residency planning -------------------------------------------------

    def _mip_texels(self, ti: int, level: int) -> int:
        m = self._pyramids[ti][level]
        return int(m.shape[0] * m.shape[1])

    def _resident_texels(self, mins: List[int]) -> int:
        return sum(
            self._mip_texels(ti, li)
            for ti, p in enumerate(self._pyramids)
            for li in range(mins[ti], len(p))
        )

    def _fit_residency(self) -> List[int]:
        """Greedy fit: honour the requests, then demote the finest resident
        mip of whichever texture spends the most texels until the total
        fits the budget (every texture keeps its coarsest mip)."""
        mins = [
            min(req, len(p) - 1)
            for req, p in zip(self._requested, self._pyramids)
        ]
        if self.budget_bytes is None:
            return mins
        budget_texels = self.budget_bytes // _BYTES_PER_TEXEL
        while self._resident_texels(mins) > budget_texels:
            # Demote the lowest-priority texture whose finest resident mip
            # is largest (recent request_residency calls go last).
            candidates = [
                (self._prio[ti], -self._mip_texels(ti, mins[ti]), ti)
                for ti, p in enumerate(self._pyramids)
                if mins[ti] < len(p) - 1
            ]
            if not candidates:
                raise ResourceCreationError(
                    f"texture budget {self.budget_bytes} B cannot hold even "
                    f"the coarsest mips of {len(self._pyramids)} textures"
                )
            candidates.sort()
            mins[candidates[0][2]] += 1
        return mins

    def pool(self) -> Optional[TexturePool]:
        """Build (or return the cached) device pool; None if no textures."""
        if not self._pyramids:
            return None
        if self._dirty or self._pool is None:
            mins = self._fit_residency()
            arena = (
                self.budget_bytes // _BYTES_PER_TEXEL
                if self.budget_bytes is not None
                else None
            )
            rebuilt = self._pool is not None
            self._pool = build_pool(
                self._pyramids, min_levels=mins, arena_texels=arena,
                device=self.device,
            )
            self._resident = mins
            self._dirty = False
            if rebuilt:
                self.restream_count += 1
        return self._pool

    def stats(self) -> dict:
        texels = sum(
            int(m.shape[0] * m.shape[1]) for p in self._pyramids for m in p
        )
        resident = (
            self._resident_texels(self._resident)
            if self._resident
            else texels
        )
        return {
            "textures": len(self._pyramids),
            "capacity": self.capacity,
            "texels": texels,
            "bytes": texels * _BYTES_PER_TEXEL,
            "resident_bytes": resident * _BYTES_PER_TEXEL,
            "budget_bytes": self.budget_bytes,
            "restreams": self.restream_count,
        }
