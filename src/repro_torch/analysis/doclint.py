"""Docs checker: README/docs references must point at things that exist
-- the port of ``repro/analysis/doclint.py``.

The docs layer (``README.md``, ``docs/*.md``) is living documentation —
its code blocks and inline references are the public surface of the
repo.  This lint greps them for three reference kinds and verifies each
against the tree, so a renamed Make target, a dropped env var, or a
moved module cannot silently rot the docs:

1. ``make <target>`` mentions — the target must exist in the Makefile;
2. ``REPRO_TORCH_*`` env vars — the variable must be read somewhere
   under ``src/repro_torch``;
3. backticked repo paths (``src/repro_torch/dist/lm.py``,
   ``docs/serving.md``, ``BENCH_serve.json``, …) and ``python -m
   repro_torch.x.y`` module references — the file/directory must exist.
   Bare filenames without a directory part (````halo.py````) pass if
   they exist anywhere in the tree; dotfiles (machine-local caches) are
   skipped.

Paths may be written from the repo root, from ``src/`` or from either
package (``kernels/csrc/conv2d.cu``, ``launch/serve.py``): the README
documents both.

Run directly: ``python -m repro_torch.analysis.doclint [root]`` — exit 1
with one line per stale reference.  This module imports neither torch
nor jax.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
from typing import List, Set

#: Suffixes that make a backticked token a path candidate even without
#: a directory separator.
PATH_SUFFIXES = (".py", ".md", ".json", ".toml", ".yml", ".yaml")

_MAKE_RE = re.compile(r"\bmake ([A-Za-z0-9_-]+)")
_ENV_RE = re.compile(r"\b(REPRO_TORCH_[A-Z0-9_]+)\b")
_TICK_RE = re.compile(r"`([^`\n]+)`")
_MODULE_RE = re.compile(r"python -m (repro_torch(?:\.[A-Za-z0-9_]+)+)")
_TARGET_RE = re.compile(r"^([A-Za-z0-9_-]+):", re.MULTILINE)


@dataclasses.dataclass(frozen=True)
class DocFinding:
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.message}"


def default_root() -> str:
    here = os.path.abspath(__file__)
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))


def doc_files(root: str) -> List[str]:
    out = []
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        out.append(readme)
    docs = os.path.join(root, "docs")
    if os.path.isdir(docs):
        out.extend(os.path.join(docs, f) for f in sorted(os.listdir(docs))
                   if f.endswith(".md"))
    return out


def make_targets(root: str) -> Set[str]:
    path = os.path.join(root, "Makefile")
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return set(_TARGET_RE.findall(f.read())) - {".PHONY"}


def env_vars_in_source(root: str) -> Set[str]:
    found: Set[str] = set()
    for dirpath, _, files in os.walk(os.path.join(root, "src",
                                                  "repro_torch")):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(dirpath, fname)) as f:
                    found.update(_ENV_RE.findall(f.read()))
    return found


def _path_exists(root: str, token: str) -> bool:
    token = token.rstrip("/")
    # repo-relative, or relative to src/ or a package (docs often name
    # modules the way the package sees them: `launch/serve.py`)
    for base in ("", "src", os.path.join("src", "repro_torch"),
                 os.path.join("src", "repro")):
        if os.path.exists(os.path.join(root, base, token)):
            return True
    if "/" not in token:
        for dirpath, _, files in os.walk(root):
            if ".git" in dirpath:
                continue
            if token in files:
                return True
    return False


def _is_path_candidate(token: str) -> bool:
    if any(ch in token for ch in " =<>{}*$(),|"):
        return False
    if token.startswith("."):           # machine-local caches etc.
        return False
    if token.startswith("--"):          # CLI flags
        return False
    return "/" in token or token.endswith(PATH_SUFFIXES)


def lint_file(path: str, root: str, *, targets: Set[str],
              env_vars: Set[str]) -> List[DocFinding]:
    findings: List[DocFinding] = []
    with open(path) as f:
        lines = f.readlines()
    rel = os.path.relpath(path, root)
    in_fence = False
    for ln, text in enumerate(lines, 1):
        if text.lstrip().startswith("```"):
            in_fence = not in_fence
            continue
        # `make <target>` is a command reference only in code context
        # (fenced block or inline backticks) — prose like "the make
        # targets table" is not a reference
        code = text if in_fence else " ".join(_TICK_RE.findall(text))
        for tgt in _MAKE_RE.findall(code):
            if tgt not in targets:
                findings.append(DocFinding(
                    rel, ln, f"make target '{tgt}' not in Makefile"))
        for var in _ENV_RE.findall(text):
            if var not in env_vars:
                findings.append(DocFinding(
                    rel, ln, f"env var '{var}' not read under "
                             f"src/repro_torch"))
        for mod in _MODULE_RE.findall(text):
            sub = os.path.join(*mod.split("."))
            if not (_path_exists(root, sub + ".py")
                    or _path_exists(root, sub)):
                findings.append(DocFinding(
                    rel, ln, f"module '{mod}' has no source file"))
        for token in _TICK_RE.findall(text):
            if _is_path_candidate(token) and not _path_exists(root, token):
                findings.append(DocFinding(
                    rel, ln, f"path '{token}' does not exist"))
    return findings


def lint_tree(root: str) -> List[DocFinding]:
    files = doc_files(root)
    if not files:
        return [DocFinding("README.md", 0, "no README.md or docs/ found")]
    targets = make_targets(root)
    env_vars = env_vars_in_source(root)
    out: List[DocFinding] = []
    for path in files:
        out.extend(lint_file(path, root, targets=targets,
                             env_vars=env_vars))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0]) if argv else default_root()
    findings = lint_tree(root)
    for f in findings:
        print(f, file=sys.stderr)
    n_docs = len(doc_files(root))
    if findings:
        print(f"doclint: {len(findings)} stale reference(s) in {n_docs} "
              f"doc file(s)", file=sys.stderr)
        return 1
    print(f"doclint: {n_docs} doc file(s) clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
