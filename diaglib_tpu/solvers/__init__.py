"""Solver drivers (JAX re-designs of diaglib.f90's six drivers)."""

from .caslr import caslr, caslr_eff
from .davidson import davidson, gen_david
from .lobpcg import lobpcg
from .mixed import (
    LROps,
    caslr_eff_ladder,
    caslr_ladder,
    davidson_ladder,
    gen_david_ladder,
    lobpcg_ladder,
    nonsym_ladder,
)
from .nonsym import (NonsymPassResult, nonsym, nonsym_finalize,
                     nonsym_pass, nonsym_seed_left)

__all__ = [
    "LROps",
    "caslr",
    "caslr_eff",
    "caslr_eff_ladder",
    "caslr_ladder",
    "davidson",
    "davidson_ladder",
    "gen_david",
    "gen_david_ladder",
    "lobpcg",
    "lobpcg_ladder",
    "NonsymPassResult",
    "nonsym",
    "nonsym_finalize",
    "nonsym_pass",
    "nonsym_ladder",
    "nonsym_seed_left",
]
