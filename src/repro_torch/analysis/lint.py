"""AST lint rules encoding the repo's hard-won serving conventions (the
reference's ``repro.analysis.lint``, copied rule for rule; only the default
directory list and the root lookup are the port's own).

Each rule is a bug class that has actually bitten (or nearly bitten) a PR:

* ``L001 interpret-hardcoded`` — ``interpret=True`` literal at a kernel
  call site.  Pallas interpret mode must be platform-derived (the bug
  class: a hardcoded flag ships the interpreter to TPU or breaks CPU
  CI), e.g. ``interpret=jax.default_backend() != "tpu"``.
* ``L002 raw-clock`` — ``time.time()`` in scheduler/observability code.
  Spans, latency metrics and the trace recorder all share one
  ``time.perf_counter`` clock; mixing in wall-clock time skews TTFT/ITL
  reconstruction across the two.
* ``L003 metrics-bypass`` — assigning/augmenting a metric's read-side
  attributes (``.total``, ``.value``) instead of going through
  ``MetricsRegistry`` mutators (``inc``/``set``/``observe``); bypass
  writes dodge the registry's export and schema accounting.
* ``L004 bench-writer`` — opening a ``BENCH_*.json`` for writing anywhere
  but ``benchmarks/stamp.py``.  Every benchmark artifact must carry the
  provenance stamp (git sha, seed, device, schema version) that
  ``stamp.stamp_and_write()`` applies; raw writers produce artifacts the
  nightly regression gate cannot trust.
"""
from __future__ import annotations

import ast
import glob
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding

#: Attributes on metric objects that are read-side views; assigning them
#: bypasses the registry.
_METRIC_READ_ATTRS = ("total", "value")

#: (rule id, path substrings the rule applies to — empty = everywhere)
_CLOCK_SCOPES = ("serve/", "obs/")

#: L001 exempts tests: kernel unit tests pin ``interpret=True`` on purpose
#: (the oracle comparisons must run the interpreter regardless of host).
_INTERPRET_EXEMPT = ("tests/",)


def _finding(rule: str, severity: str, path: str, node: ast.AST, op: str,
             hint: str) -> Finding:
    return Finding(
        pass_name=f"lint/{rule}", severity=severity, op=op, hint=hint,
        where=f"{path}:{getattr(node, 'lineno', 0)}",
    )


def _scoped(path: str, scopes: Sequence[str]) -> bool:
    norm = path.replace(os.sep, "/")
    return any(s in norm for s in scopes)


def lint_source(src: str, path: str) -> List[Finding]:
    """Run every rule over one file's source text."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(
            pass_name="lint/parse", severity="error",
            op=f"SyntaxError: {e.msg}", hint="file does not parse",
            where=f"{path}:{e.lineno or 0}",
        )]
    findings: List[Finding] = []
    exempt_stamp = path.replace(os.sep, "/").endswith("benchmarks/stamp.py")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if not _scoped(path, _INTERPRET_EXEMPT):
                findings += _check_interpret(node, path)
            if _scoped(path, _CLOCK_SCOPES):
                findings += _check_raw_clock(node, path)
            if not exempt_stamp:
                findings += _check_bench_writer(node, path)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            findings += _check_metrics_bypass(node, path)
    return findings


def _check_interpret(node: ast.Call, path: str) -> List[Finding]:
    for kw in node.keywords:
        if kw.arg == "interpret" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return [_finding(
                "interpret-hardcoded", "error", path, node,
                "interpret=True at a kernel call site",
                "derive the flag from the platform (e.g. "
                "jax.default_backend() != 'tpu' / _default_interpret()); "
                "a hardcoded True ships the Pallas interpreter to TPU",
            )]
    return []


def _check_raw_clock(node: ast.Call, path: str) -> List[Finding]:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "time" \
            and isinstance(fn.value, ast.Name) and fn.value.id == "time":
        return [_finding(
            "raw-clock", "error", path, node,
            "time.time() in scheduler/observability code",
            "use time.perf_counter() — spans, latency metrics and traces "
            "share one monotonic clock; wall time skews reconstruction",
        )]
    return []


def _check_metrics_bypass(node: ast.AST, path: str) -> List[Finding]:
    targets: List[ast.expr]
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
    else:
        return []
    out: List[Finding] = []
    for tgt in targets:
        if isinstance(tgt, ast.Attribute) and tgt.attr in _METRIC_READ_ATTRS:
            out.append(_finding(
                "metrics-bypass", "error", path, node,
                f"assignment to .{tgt.attr} on a metric object",
                "mutate through MetricsRegistry (counter.inc() / "
                "gauge.set() / histogram.observe()); attribute writes "
                "bypass export and schema accounting",
            ))
    return out


def _string_args(node: ast.Call) -> Iterable[Tuple[str, ast.AST]]:
    for arg in list(node.args) + [kw.value for kw in node.keywords]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            yield arg.value, arg
        elif isinstance(arg, ast.JoinedStr):
            # join the constant fragments so a name split around an
            # interpolation (f"BENCH_{name}.json") still matches
            parts = [part.value for part in arg.values
                     if isinstance(part, ast.Constant)
                     and isinstance(part.value, str)]
            if parts:
                yield "".join(parts), arg


def _write_mode(node: ast.Call) -> bool:
    mode: Optional[str] = None
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        mode = str(node.args[1].value)
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = str(kw.value.value)
    return mode is None or any(c in mode for c in "wax+")


def _check_bench_writer(node: ast.Call, path: str) -> List[Finding]:
    fn = node.func
    if not (isinstance(fn, ast.Name) and fn.id == "open"):
        return []
    for text, _ in _string_args(node):
        if "BENCH_" in text and text.endswith(".json") and _write_mode(node):
            return [_finding(
                "bench-writer", "error", path, node,
                f"raw open() writer for {text!r}",
                "benchmark artifacts must go through "
                "benchmarks/stamp.stamp_and_write() so every BENCH_*.json "
                "carries provenance (git sha, seed, device, schema)",
            )]
    return []


#: Paths linted by default, relative to the repo root: the port, its tests
#: and its card smoke (the reference's own list, ``src/repro``,
#: ``benchmarks``, ``examples`` and ``tests``, is the reference's to lint).
#: An entry may be a glob.
DEFAULT_LINT_DIRS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py")


def repo_root() -> Optional[str]:
    """The checkout root, inferred from this file's location (None when the
    package is installed without its repo layout)."""
    here = os.path.abspath(os.path.dirname(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    if os.path.isdir(os.path.join(root, "src", "repro_torch")):
        return root
    return None


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    findings: List[Finding] = []
    for path in paths:
        if os.path.isfile(path):
            files = [path]
        else:
            files = [
                os.path.join(dirpath, f)
                for dirpath, _, names in os.walk(path)
                for f in sorted(names) if f.endswith(".py")
            ]
        for fname in sorted(files):
            with open(fname, encoding="utf-8") as fh:
                findings += lint_source(fh.read(), fname)
    return findings


def lint_repo(root: Optional[str] = None) -> List[Finding]:
    """Lint the default path set under the repo root."""
    root = root if root is not None else repo_root()
    if root is None:
        return []
    paths = sorted({p for d in DEFAULT_LINT_DIRS
                    for p in glob.glob(os.path.join(root, d))})
    return lint_paths(paths)
