"""Mesh coordinates with wildcard merging (``oim_tpu/common/meshcoord.py``).

A chip's position is ``x,y,z[,core]`` and ``-1`` means unset; ``complete``
fills unset components from a second source. A CUDA card has no torus
position: ``CUDABackend.coord_of`` gives every component unset, as the
JAX package does off a TPU. ``to_proto``/``from_proto`` convert to the
wire's ``MeshCoordinate`` and import protobuf inside the method, so the
module loads on a machine without protobuf.
"""

from __future__ import annotations

import dataclasses

UNSET = -1


@dataclasses.dataclass(frozen=True)
class MeshCoord:
    x: int = UNSET
    y: int = UNSET
    z: int = UNSET
    core: int = UNSET

    @classmethod
    def parse(cls, s: str) -> "MeshCoord":
        """Parse 'x,y,z[,core]'; '*' or '' for unset components."""
        if not s:
            return cls()
        parts = s.split(",")
        if len(parts) not in (3, 4):
            raise ValueError(f"mesh coordinate must be x,y,z[,core]: {s!r}")
        vals = []
        for p in parts:
            p = p.strip()
            if p in ("*", ""):
                vals.append(UNSET)
            else:
                v = int(p)
                if v < 0:
                    raise ValueError(f"negative mesh coordinate component: {s!r}")
                vals.append(v)
        while len(vals) < 4:
            vals.append(UNSET)
        return cls(*vals)

    def format(self) -> str:
        """Canonical string form ('*' for unset)."""
        comps = [self.x, self.y, self.z]
        if self.core != UNSET:
            comps.append(self.core)
        return ",".join("*" if c == UNSET else str(c) for c in comps)

    def complete(self, default: "MeshCoord") -> "MeshCoord":
        """Fill unset components from ``default``."""
        return MeshCoord(
            self.x if self.x != UNSET else default.x,
            self.y if self.y != UNSET else default.y,
            self.z if self.z != UNSET else default.z,
            self.core if self.core != UNSET else default.core,
        )

    def is_complete(self) -> bool:
        return UNSET not in (self.x, self.y, self.z)

    def to_proto(self):
        from oim_tpu_torch.spec import oim_pb2 as pb

        return pb.MeshCoordinate(x=self.x, y=self.y, z=self.z, core=self.core)

    @classmethod
    def from_proto(cls, msg) -> "MeshCoord":
        return cls(msg.x, msg.y, msg.z, msg.core)
