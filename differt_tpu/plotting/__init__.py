"""Multi-backend plotting (plotly / matplotlib).

Reference parity: ``differt.plotting`` (differt/src/differt/plotting/) —
the same ``draw_*`` primitive set with backend dispatch, a process-global
default backend, per-backend default kwargs, and a ``reuse`` context that
accumulates several draws into one figure. The vispy backend is optional
(it needs a canvas, which headless hosts lack); plotly and matplotlib
cover interactive and static use.
"""

from ._core import (
    draw_contour,
    draw_image,
    draw_markers,
    draw_mesh,
    draw_paths,
    draw_rays,
    draw_surface,
)
from ._utils import (
    PlotOutput,
    dispatch,
    get_backend,
    reuse,
    set_backend,
    set_defaults,
    update_defaults,
    use,
)

__all__ = [
    "PlotOutput",
    "draw_contour",
    "draw_image",
    "draw_markers",
    "draw_mesh",
    "draw_paths",
    "draw_rays",
    "draw_surface",
    "dispatch",
    "get_backend",
    "reuse",
    "set_backend",
    "set_defaults",
    "update_defaults",
    "use",
]
