"""Several devices for one block: the stamp solves of a round spread over
local devices (parallel/mesh.py)."""

from .mesh import (  # noqa: F401
    make_mesh,
    on_device,
    reduce_stats,
    sharded_stamp_solve,
    solve_finalize_mesh,
)
