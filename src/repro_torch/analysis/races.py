"""Static page-aliasing race checker over ``PagedScheduler`` batch plans
(the reference's ``repro.analysis.races``, copied: framework-free).

One device launch scatter-writes KV rows at ``(page, offset)`` coordinates
derived from each lane's page table and position span.  The pool invariants
that make COW prefix sharing, speculative rollback and defrag sound are:

* no two lanes write the same physical ``(page, offset)`` in one launch —
  the scatter would be order-dependent;
* a written page is exclusively owned (``refcount == 1``): writing a
  ``refcount > 1`` page mutates someone else's history absent a COW copy;
* a written page is never in the prefix trie — trie pages are immutable
  shared history until evicted (spec staging must COW before drafting);
* a written page is allocated (not on the pool free list) and the offset
  is inside the page.

:func:`check_plan` proves them for one planned tick.  The scheduler's
``analysis_debug`` mode submits every launch's plan here *before* the
device call and raises :class:`PageRaceError` on any finding; tests replay
recorded admit→preempt→defrag→rollback stress schedules through it.

The garbage page (page 0) is exempt from aliasing: pad rows and clamped
out-of-range positions deliberately dump writes there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Mapping, Sequence, Tuple

from repro_torch.analysis.findings import Finding

PASS = "races/page-aliasing"


@dataclasses.dataclass(frozen=True)
class PageWrite:
    """One lane's planned KV write: token at ``offset`` of physical ``page``."""

    lane: int
    uid: int
    page: int
    offset: int


@dataclasses.dataclass(frozen=True)
class TickPlan:
    """Everything one launch is about to scatter, plus the pool ledger.

    refcounts:  pool refcount per page the plan touches (missing → 0).
    trie_pages: pages currently owned by the prefix trie.
    free_pages: pages currently on the pool free list.
    """

    phase: str
    page_size: int
    writes: Tuple[PageWrite, ...]
    refcounts: Mapping[int, int]
    trie_pages: FrozenSet[int]
    free_pages: FrozenSet[int]
    garbage_page: int = 0

    @staticmethod
    def build(
        phase: str,
        page_size: int,
        writes: Sequence[PageWrite],
        refcounts: Mapping[int, int],
        trie_pages: Sequence[int] = (),
        free_pages: Sequence[int] = (),
        garbage_page: int = 0,
    ) -> "TickPlan":
        return TickPlan(
            phase=phase,
            page_size=page_size,
            writes=tuple(writes),
            refcounts=dict(refcounts),
            trie_pages=frozenset(trie_pages),
            free_pages=frozenset(free_pages),
            garbage_page=garbage_page,
        )


class PageRaceError(AssertionError):
    """Raised by the scheduler's debug mode when a plan fails the checker."""

    def __init__(self, plan: TickPlan, findings: List[Finding]) -> None:
        self.plan = plan
        self.findings = findings
        lines = "\n".join(f.format() for f in findings)
        super().__init__(
            f"page-aliasing race in {plan.phase!r} launch plan "
            f"({len(findings)} finding(s)):\n{lines}"
        )


def check_plan(plan: TickPlan) -> List[Finding]:
    """Prove the aliasing invariants for one planned launch; findings on
    any violation (empty list == the plan is race-free)."""
    findings: List[Finding] = []
    seen: Dict[Tuple[int, int], PageWrite] = {}
    for w in plan.writes:
        if w.page == plan.garbage_page:
            continue  # the designated dump target: aliasing is the point
        if not 0 <= w.offset < plan.page_size:
            findings.append(Finding(
                pass_name=PASS, severity="error",
                op=f"write page={w.page} offset={w.offset}",
                hint=f"offset outside [0, page_size={plan.page_size}) — "
                     "position→(page, offset) mapping is broken",
                where=f"{plan.phase}:lane{w.lane}:uid{w.uid}",
            ))
            continue
        key = (w.page, w.offset)
        prev = seen.get(key)
        if prev is not None and prev.lane != w.lane:
            findings.append(Finding(
                pass_name=PASS, severity="error",
                op=f"double-write page={w.page} offset={w.offset}",
                hint=f"lanes {prev.lane} (uid {prev.uid}) and {w.lane} "
                     f"(uid {w.uid}) both scatter this physical slot in one "
                     "launch — scatter order would decide whose KV survives",
                where=f"{plan.phase}:lane{w.lane}:uid{w.uid}",
            ))
        seen.setdefault(key, w)
        rc = plan.refcounts.get(w.page, 0)
        if w.page in plan.free_pages or rc == 0:
            findings.append(Finding(
                pass_name=PASS, severity="error",
                op=f"write to unallocated page={w.page}",
                hint="the page is on the free list / refcount 0 — a later "
                     "alloc would hand it to another lane mid-flight",
                where=f"{plan.phase}:lane{w.lane}:uid{w.uid}",
            ))
        elif rc > 1:
            findings.append(Finding(
                pass_name=PASS, severity="error",
                op=f"write to shared page={w.page} (refcount={rc})",
                hint="refcount > 1 means another lane or the prefix trie "
                     "still reads this page — copy-on-write "
                     "(_cow_shared_page) must run before the lane writes",
                where=f"{plan.phase}:lane{w.lane}:uid{w.uid}",
            ))
        if w.page in plan.trie_pages:
            findings.append(Finding(
                pass_name=PASS, severity="error",
                op=f"write aliases prefix-trie page={w.page}",
                hint="trie pages are immutable shared history; spec staging "
                     "and prefill must COW or allocate fresh pages instead",
                where=f"{plan.phase}:lane{w.lane}:uid{w.uid}",
            ))
    return findings


def assert_plan_ok(plan: TickPlan) -> None:
    """Raise :class:`PageRaceError` if the plan has any finding."""
    findings = check_plan(plan)
    if findings:
        raise PageRaceError(plan, findings)
