"""Static analysis for the port's DA serving stack (the reference's
``repro.analysis``, over FX graphs instead of jaxprs and HLO).

Three layers, one CLI (``python -m repro_torch.analysis.check``):

* :mod:`repro_torch.analysis.passes` — graph invariant passes over traced
  serving steps (multiplier-free, no-big-gather, no-host-sync,
  dtype-discipline); :mod:`repro_torch.analysis.graph` traces the steps
  with ``make_fx``, each kernel one custom-op node.
* :mod:`repro_torch.analysis.races` — static page-aliasing race checker over
  ``PagedScheduler`` batch plans (also wired into the scheduler's
  ``analysis_debug`` mode).
* :mod:`repro_torch.analysis.lint` — AST lint rules encoding repo
  conventions (platform-derived ``interpret``, shared clock, metrics
  registry, benchmark provenance).

Every layer reports through :class:`repro_torch.analysis.findings.Finding`,
so CI and the CLI render one table.  The reference's ``hlo.py`` (an XLA HLO
text parser) has no counterpart: the structural passes walk FX nodes.
"""
from repro_torch.analysis.findings import Finding, errors, render
from repro_torch.analysis.races import PageRaceError, PageWrite, TickPlan, check_plan

__all__ = [
    "Finding",
    "PageRaceError",
    "PageWrite",
    "TickPlan",
    "check_plan",
    "errors",
    "render",
]
