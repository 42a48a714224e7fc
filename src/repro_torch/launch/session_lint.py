"""Round lint of the port: no device fence on the serving round path.

The port's half of rule 3 of ``tools/session_lint.py`` (which reads the
reference package only). A call of ``synchronize``, ``item``, ``tolist``
or ``cpu`` makes the host wait for the device, so a serving round stays
asynchronous only if every such call in ``repro_torch/serving/`` and
``core/pipeline.py`` sits in a function where a wait is meant (``ALLOWED``,
each with its reason): the session's sampled ``_fence`` and the guard's
one read a checked round; off the round, the explicit drains, the
staging set's reuse gate, a snapshot writer's wait and the LM
``generate``'s phase clock. Any other fence
there is a violation, and so is an allowed function that is gone (a
rename updates the list).

    PYTHONPATH=src python -m repro_torch.launch.session_lint

exits non-zero listing every violation.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

#: method names whose call waits for the device
FENCES = {"synchronize", "item", "tolist", "cpu"}

#: (file under the package, qualified function) -> why it may wait
ALLOWED = {
    ("serving/session.py", "_fence"):
        "the round's only wait, made on trace-sampled rounds",
    ("serving/guard.py", "FleetGuard._health_check"):
        "the guard's one read of every cohort's flags a checked round",
    ("serving/session.py", "SessionManager.sync"):
        "the drain a caller asks for (summary, removal, teardown)",
    ("serving/session.py", "_HostStager.stage"):
        "a staging set's reuse gate, on work two rounds old",
    ("serving/session.py", "_HostStager.drain"):
        "the staging sets' drain before a relayout",
    ("serving/session.py", "_as_host_tuple"):
        "a batch handed over on the device, brought to the host stager",
    ("serving/cluster.py", "_Capture.wait"):
        "a snapshot writer's wait for its copies, off the round",
    ("serving/engine.py", "StreamingEngine._sync"):
        "the engine's per-batch latency, which ends on the device",
    ("serving/lm_serve.py", "_clock"):
        "LM generate's clock, read at a phase's start and end (no round)",
}


def _files(root: Path) -> list:
    return sorted(root.glob("serving/*.py")) + [root / "core/pipeline.py"]


def _fences(tree: ast.Module) -> list:
    """``(line, call, qualified function)`` of every fence call; the
    function is the chain of enclosing classes and functions."""
    out = []

    def visit(node, scope):
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                visit(sub, scope + (sub.name,))
                continue
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in FENCES):
                out.append((sub.lineno, sub.func.attr, ".".join(scope)))
            visit(sub, scope)

    visit(tree, ())
    return out


def lint(root: Path) -> list:
    """Every violation under the package directory ``root``."""
    errors, seen = [], set()
    for path in _files(root):
        rel = path.relative_to(root).as_posix()
        tree = ast.parse(path.read_text(), str(path))
        for line, call, fn in _fences(tree):
            if (rel, fn) in ALLOWED:
                seen.add((rel, fn))
                continue
            errors.append(f"{rel}:{line}: .{call}() in {fn or '<module>'} "
                          "waits for the device on the round path; fence "
                          "only in session._fence (sampled rounds) or the "
                          "guard's one read")
    for rel, fn in sorted(set(ALLOWED) - seen):
        errors.append(f"{rel}: allowed fence site {fn} not found; update "
                      "ALLOWED alongside the rename")
    return errors


def main(argv=None) -> int:
    root = Path(__file__).resolve().parents[1]
    errors = lint(root)
    for e in errors:
        print(e, file=sys.stderr)
    if errors:
        return 1
    print(f"session-lint: OK ({len(_files(root))} files, "
          f"{len(ALLOWED)} allowed fence sites)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
