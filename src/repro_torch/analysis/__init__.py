"""The schedule verifier and the source lints -- the port of
``repro/analysis``.

Every property the paper's algorithms promise -- per-schedule wire
volume, slab-vs-gathered peak memory, total ring permutations -- is
checked here on what the port actually issues.  The reference compiles
each cell and parses its HLO; the port runs each (op, grid, schedule)
cell on a process group and reads the
:class:`repro_torch.dist.collectives.CollectiveNote` every rank records
for every collective it runs.

Passes
------
* **collective extraction** (:mod:`repro_torch.analysis.collect`) -- the
  ranks' notes lined up into one record per collective, its permute
  pairs mapped to global ranks, attributed to mesh axes; ranks that
  recorded different sequences are an SPMD divergence.
* **deadlock / ring lint**
  (:func:`repro_torch.analysis.lints.lint_deadlock`) -- ppermute pairs
  must have unique sources and targets, every orbit must sit inside one
  mesh-axis group, cycles must cover their whole ring, and axes whose
  notes carry a ring tag must see total single-cycle rotations.
* **footprint lint** (:func:`repro_torch.analysis.lints.lint_footprint`)
  -- ring schedules run *no* all-gather on a contraction operand, and on
  a card the allocator's peak over the cell tracks the analytic
  ``conv/matmul_mem_elems`` (the paper's Eq. 11) within a band.
* **accounting drift guard** (:func:`repro_torch.analysis.lints.lint_wire`)
  -- every rank's recorded wire bytes equal ``conv/matmul_comm_elems``
  and ``*_train_comm_elems`` (ratio 1.00) for forward and backward.
* **attribution cross-check**
  (:func:`repro_torch.analysis.lints.lint_attribution`) -- the notes'
  wire, summed by device partition, equals the accounting's terms on
  those axes; no collective runs where no term is paid, and no term goes
  unpaid.
* **source AST lint** (:mod:`repro_torch.analysis.astlint`) -- no call
  into ``torch.distributed`` outside ``dist/collectives.py`` and
  ``dist/spawn.py``, and the kernel modules imported only inside
  ``kernels/``.
* **doc lint** (:mod:`repro_torch.analysis.doclint`) -- the README's and
  ``docs/``' references to paths, make targets, ``REPRO_TORCH_*``
  variables and ``python -m repro_torch.*`` modules exist.

Entry points: ``python -m repro_torch.analysis.lint`` (CLI) and
:func:`repro_torch.analysis.verify.run_matrix`.  This package's
``__init__``, ``collect``, ``lints``, ``astlint`` and ``doclint`` import
neither torch nor jax; ``verify`` and ``lint`` run the port.
"""

from repro_torch.analysis.collect import (Collective, axis_groups,
                                          extract_collectives)
from repro_torch.analysis.lints import (Finding, lint_attribution,
                                        lint_deadlock, lint_footprint,
                                        lint_wire)

__all__ = [
    "Collective", "Finding", "axis_groups", "extract_collectives",
    "lint_attribution", "lint_deadlock", "lint_footprint", "lint_wire",
]
