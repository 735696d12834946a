"""Memory-budget hybrid partitioner: an in-memory skew core plus a streamed
tail (the port of ``repro.hybrid``; HEP, Mayer & Jacobsen, PAPERS.md).

A caller-supplied byte budget is split between the two halves the port
already owns: the Θ/ξ skew separator with its CMS sketches, and the
streamed Alg. 3 placement with :class:`~repro_torch.streaming.HostBudget`
accounting.

- :mod:`.planner`: :func:`plan_budget` sizes the resident core from a CMS
  degree sketch (K4a/K4b on the card) and picks the core threshold ξ*
  (budget 0 ⇒ pure streaming; a budget covering the edge list ⇒ fully
  in-memory);
- :mod:`.refiner`: the resident core is refined by the masked Stackelberg
  game (K5 sums) and placed by Alg. 3 (K2), and
  :class:`TailAssignCarry` streams the rest through K2 with the core's
  edges masked out;
- :mod:`.driver`: :func:`run_hybrid` makes the budget-bounded pass and
  packs a standard warm bundle, which :class:`HybridServingChain` serves
  through the :class:`~repro_torch.serving.ServingController`.

One knob, ``S5PConfig.host_budget`` / ``--host-budget``, sweeps pure
streaming → hybrid → fully in-memory.
"""

from .planner import (  # noqa: F401
    BudgetPlan,
    CORE_EDGE_BYTES,
    build_degree_sketch,
    plan_budget,
)
from .refiner import TailAssignCarry, core_move_mask, place_core  # noqa: F401
from .driver import (  # noqa: F401
    HybridResult,
    HybridServingChain,
    run_hybrid,
)

__all__ = [
    "BudgetPlan",
    "CORE_EDGE_BYTES",
    "build_degree_sketch",
    "plan_budget",
    "TailAssignCarry",
    "core_move_mask",
    "place_core",
    "HybridResult",
    "HybridServingChain",
    "run_hybrid",
]
