"""CLI entry for the port's static verifier: ``python -m repro_torch.analysis.check``.

The reference's CLI (``python -m repro.analysis.check``), over the port:

* **graph passes** — load a frozen artifact (``--artifact DIR``,
  repeatable; the reference's artifacts boot too) or freeze fresh
  smoke-scale models from the config zoo (``--configs all`` /
  ``--configs name,name``), trace its decode / chunked-prefill /
  spec-draft steps under the gather and fused attention backends with
  ``make_fx`` (each kernel call one custom-op node), and run the pass
  pipeline: multiplier-free, no-big-gather, no-host-sync, dtype-discipline.
  The steps are traced on ``--device`` (the card unless asked otherwise), so
  the graph is the one that device runs.
* **repo lint** — the AST rules in :mod:`repro_torch.analysis.lint` over
  the port's default paths (``--lint-only`` for just this, ``--no-lint``
  to skip).
* **verdict recording** — each checked artifact's ``manifest.json`` gets
  the summary stamped under ``"analysis"`` (``--no-record`` to skip).

Exit status is 1 when any error-severity finding survives the allowlist,
0 otherwise.  ``--json OUT`` dumps the full findings list for CI upload.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, dump_json, errors, render
from repro_torch.analysis.passes import DEFAULT_ALLOWLIST, run_passes

#: bumped when the verdict dict recorded into artifact manifests changes
VERDICT_SCHEMA = 1


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="static verifier: multiplier-free serving graphs, "
                    "page-aliasing plans, repo lint",
    )
    p.add_argument("--artifact", action="append", default=[],
                   metavar="DIR", help="frozen DA artifact to check "
                   "(repeatable)")
    p.add_argument("--configs", default=None, metavar="all|name,...",
                   help="freeze smoke-scale models from the config zoo and "
                        "check their serving graphs")
    p.add_argument("--mode", default="auto",
                   help="freeze mode for --configs models (default: auto)")
    p.add_argument("--spec-gamma", type=int, default=2,
                   help="trace the fused speculative draft loop with this "
                        "gamma (0 disables; default 2)")
    p.add_argument("--device", default="cuda",
                   help="device the artifact boots on and the steps are "
                        "traced for (default: cuda)")
    p.add_argument("--no-hlo", action="store_true",
                   help="accepted for the reference's command lines and "
                        "ignored: the port has no HLO; every pass reads the "
                        "traced FX graph")
    p.add_argument("--allow", action="append", default=[], metavar="SUBSTR",
                   help="extra allowlist entry (matched against a finding's "
                        "where/op; PASS@SUBSTR matches only that pass's "
                        "findings; repeatable)")
    p.add_argument("--no-default-allow", action="store_true",
                   help="drop the built-in allowlist "
                        f"{list(DEFAULT_ALLOWLIST)}")
    p.add_argument("--lint-only", action="store_true",
                   help="run only the AST lint rules")
    p.add_argument("--no-lint", action="store_true",
                   help="skip the AST lint rules")
    p.add_argument("--no-record", action="store_true",
                   help="do not stamp the verdict into artifact manifests")
    p.add_argument("--json", default=None, metavar="OUT",
                   help="write the findings list as JSON")
    return p


def _allowlist(args: argparse.Namespace) -> Tuple[str, ...]:
    base = () if args.no_default_allow else DEFAULT_ALLOWLIST
    return tuple(base) + tuple(args.allow)


def _outside_coverage(name: str, where: str) -> Finding:
    return Finding(
        pass_name="graph/trace", severity="note",
        op=f"config {name} is outside paged-tracer coverage",
        hint="non-attention mixers serve through the slot runtime; "
             "embedding-input modalities have no token step to trace",
        where=where,
    )


def check_artifact(
    directory: str,
    *,
    spec_gamma: int = 2,
    allow: Sequence[str] = DEFAULT_ALLOWLIST,
    device: Any = "cuda",
) -> Tuple[List[Finding], List[str]]:
    """Graph-pass findings for one on-disk artifact (+ names of the steps
    actually traced).  An artifact without a model config cannot be traced
    — that is itself an error finding, not a silent skip."""
    from repro_torch.analysis.graph import supports_paged_tracing, trace_serving_steps
    from repro_torch.core.freeze import load_artifact

    art = load_artifact(directory, device=device)
    if art.model_cfg is None:
        return [Finding(
            pass_name="graph/trace", severity="error",
            op="artifact has no model_cfg",
            hint="re-freeze with model_cfg= so the serving graph can be "
                 "rebuilt and verified",
            where=directory,
        )], []
    if not supports_paged_tracing(art.model_cfg):
        return [_outside_coverage(art.model_cfg.name, directory)], []
    steps = trace_serving_steps(art.params, art.model_cfg, spec_gamma=spec_gamma)
    return run_passes(steps, allow=allow), [s.name for s in steps]


def check_config(
    name: str,
    *,
    mode: str = "auto",
    spec_gamma: int = 2,
    allow: Sequence[str] = DEFAULT_ALLOWLIST,
    device: Any = "cuda",
) -> Tuple[List[Finding], List[str]]:
    """Freeze one zoo config at smoke scale and run the graph passes."""
    from repro_torch.analysis.graph import supports_paged_tracing, trace_serving_steps
    from repro_torch.configs.registry import get, reduce_for_smoke
    from repro_torch.core.da import DAConfig
    from repro_torch.core.freeze import freeze_model
    from repro_torch.models.model import init_model

    cfg = reduce_for_smoke(get(name))
    if not supports_paged_tracing(cfg):
        return [_outside_coverage(name, f"configs:{name}")], []
    params = init_model(cfg, seed=0, device=device)
    art = freeze_model(params, DAConfig(x_signed=True), mode=mode,
                       model_cfg=cfg, device=device)
    steps = trace_serving_steps(art.params, cfg, spec_gamma=spec_gamma)
    return run_passes(steps, allow=allow), [s.name for s in steps]


def verdict_of(findings: Sequence[Finding],
               checked: Sequence[str]) -> Dict[str, Any]:
    """The summary dict recorded into an artifact manifest."""
    by_pass: Dict[str, int] = {}
    for f in findings:
        by_pass[f.pass_name] = by_pass.get(f.pass_name, 0) + 1
    n_err = len(errors(findings))
    return {
        "schema": VERDICT_SCHEMA,
        "ok": n_err == 0,
        "errors": n_err,
        "warnings": sum(1 for f in findings if f.severity == "warning"),
        "notes": sum(1 for f in findings if f.severity == "note"),
        "findings_by_pass": by_pass,
        "steps_checked": list(checked),
        "checked_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    allow = _allowlist(args)
    findings: List[Finding] = []

    if not args.lint_only:
        for directory in args.artifact:
            fs, checked = check_artifact(
                directory, spec_gamma=args.spec_gamma, allow=allow,
                device=args.device,
            )
            findings += fs
            print(f"[graph] {directory}: {len(checked)} step(s) traced, "
                  f"{len(fs)} finding(s)")
            if not args.no_record and checked:
                from repro_torch.core.freeze import record_analysis

                record_analysis(directory, verdict_of(fs, checked))
        if args.configs:
            from repro_torch.configs.registry import ARCHS

            names = (sorted(ARCHS) if args.configs == "all"
                     else [n.strip() for n in args.configs.split(",")
                           if n.strip()])
            for name in names:
                try:
                    fs, checked = check_config(
                        name, mode=args.mode, spec_gamma=args.spec_gamma,
                        allow=allow, device=args.device,
                    )
                except Exception as e:  # a config that cannot even trace
                    fs, checked = [Finding(
                        pass_name="graph/trace", severity="error",
                        op=f"{type(e).__name__}: {e}",
                        hint="freezing or tracing this config crashed — the "
                             "serving graph cannot be verified",
                        where=f"configs:{name}",
                    )], []
                findings += fs
                print(f"[graph] configs:{name}: {len(checked)} step(s) "
                      f"traced, {len(fs)} finding(s)")

    if not args.no_lint:
        from repro_torch.analysis.lint import lint_repo

        fs = lint_repo()
        findings += fs
        print(f"[lint] {len(fs)} finding(s)")

    if findings:
        print(render(findings))
    if args.json:
        dump_json(findings, args.json)
        print(f"findings written to {args.json}")
    n_err = len(errors(findings))
    print(f"analysis: {len(findings)} finding(s), {n_err} error(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
