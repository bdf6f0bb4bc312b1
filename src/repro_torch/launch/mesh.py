"""Mesh definitions: a forwarder to :mod:`repro_torch.dist.sharding`,
which owns mesh construction, keeping the reference's
``repro.launch.mesh`` import path. Both are functions: importing this
module touches no process group."""
from __future__ import annotations

from repro_torch.dist.sharding import (  # noqa: F401
    make_local_mesh,
    make_production_mesh,
)
