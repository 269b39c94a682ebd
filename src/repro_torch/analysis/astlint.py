"""Source-level AST lint for the port's two dispatch chokepoints -- the
port of ``repro/analysis/astlint.py``:

1. **Raw collectives** -- no call into ``torch.distributed`` outside
   ``repro_torch/dist/collectives.py`` (the accounted wrappers, by which
   every collective stays attributable to a mesh axis and visible to the
   verifier's notes) and ``repro_torch/dist/spawn.py`` (which starts and
   ends the process groups).  Call sites opt out with
   ``# raw-collective-ok``.

2. **Raw kernels** -- the kernel modules (``kernels.matmul``,
   ``kernels.conv2d``, ``kernels.winograd``, ``kernels.gemm_conv`` and
   the build, ``kernels._build``) may only be imported inside
   ``repro_torch/kernels/``.  Everything else reaches them through the
   ``kernels.ops`` dispatchers, so the autotuned best-of selector (and
   its ``REPRO_TORCH_AUTOTUNE`` switch) cannot be silently bypassed.
   Import sites opt out with ``# raw-kernel-ok``.

Both rules parse every source file under ``src/repro_torch``, resolving
the usual spellings: ``import torch.distributed as dist``, ``import
torch`` / ``import torch.distributed`` then ``torch.distributed.x(...)``,
``from torch import distributed [as d]``, ``from torch.distributed
import all_reduce [as x]`` (and the same from its submodules);
``import repro_torch.kernels.matmul``, ``from repro_torch.kernels import
matmul``, ``from repro_torch.kernels.matmul import matmul`` and their
relative forms.  An import alone is not a call: ``from
torch.distributed.device_mesh import DeviceMesh`` for an annotation is
clean.

Run directly: ``python -m repro_torch.analysis.astlint [root]``.  This
module imports neither torch nor jax.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from typing import List, Tuple

DIST_MODULE = "torch.distributed"

#: Repo-relative suffixes allowed to call into ``torch.distributed``.
ALLOWED_SUFFIXES = (os.path.join("dist", "collectives.py"),
                    os.path.join("dist", "spawn.py"))

PRAGMA = "raw-collective-ok"

#: Kernel mechanism modules reachable only through ``kernels.ops``.
RAW_KERNEL_MODULES = frozenset({"matmul", "conv2d", "winograd", "gemm_conv",
                                "_build"})
KERNEL_PKG = "repro_torch.kernels"

#: Directory whose files may import the raw kernel modules.
KERNEL_ALLOWED_DIR = os.path.join("repro_torch", "kernels") + os.sep

KERNEL_PRAGMA = "raw-kernel-ok"


@dataclasses.dataclass(frozen=True)
class AstFinding:
    path: str
    line: int
    name: str     # the function called / kernel module imported
    kind: str = "collective"

    def __str__(self):
        if self.kind == "kernel":
            return (f"{self.path}:{self.line}: raw kernel import "
                    f"{KERNEL_PKG}.{self.name} — dispatch through "
                    f"repro_torch.kernels.ops so the autotuned selector "
                    f"stays in the loop")
        return (f"{self.path}:{self.line}: raw {self.name} call — use "
                f"repro_torch.dist.collectives so the collective stays "
                f"accounted")


def _package_of(path: str) -> List[str]:
    """The dotted package of ``path`` from its last ``repro_torch``
    directory (for relative imports), or ``[]``."""
    parts = os.path.abspath(path).split(os.sep)[:-1]
    if "repro_torch" not in parts:
        return []
    i = len(parts) - 1 - parts[::-1].index("repro_torch")
    return parts[i:]


class _Visitor(ast.NodeVisitor):
    def __init__(self, source_lines, package, *, check_kernels=True):
        self.torch_aliases = set()      # names bound to the torch module
        self.dist_aliases = {}          # name -> dotted torch.distributed.*
        self.direct = {}                # local name -> dotted callable
        self.calls: List[Tuple[int, str]] = []
        self.kernel_imports: List[Tuple[int, str]] = []
        self._check_kernels = check_kernels
        self._lines = source_lines
        self._package = package

    def _line_has(self, lineno: int, pragma: str) -> bool:
        line = self._lines[lineno - 1] if lineno - 1 < len(self._lines) \
            else ""
        return pragma in line

    def _kernel_module(self, node, module: str) -> None:
        if not self._check_kernels:
            return
        prefix = KERNEL_PKG + "."
        if module.startswith(prefix) \
                and module[len(prefix):].split(".")[0] in RAW_KERNEL_MODULES \
                and not self._line_has(node.lineno, KERNEL_PRAGMA):
            self.kernel_imports.append(
                (node.lineno, module[len(prefix):].split(".")[0]))

    def _absolute(self, node) -> str:
        if not node.level:
            return node.module or ""
        base = self._package[:len(self._package) - (node.level - 1)] \
            if node.level - 1 <= len(self._package) else []
        return ".".join(base + ([node.module] if node.module else []))

    def visit_Import(self, node):
        for a in node.names:
            if a.name == "torch":
                self.torch_aliases.add(a.asname or "torch")
            elif a.name.startswith("torch.") and not a.asname:
                self.torch_aliases.add("torch")
            if a.asname and (a.name == DIST_MODULE
                             or a.name.startswith(DIST_MODULE + ".")):
                self.dist_aliases[a.asname] = a.name
            self._kernel_module(node, a.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        module = self._absolute(node)
        if module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    self.dist_aliases[a.asname or a.name] = DIST_MODULE
        elif module == DIST_MODULE or module.startswith(DIST_MODULE + "."):
            for a in node.names:
                self.direct[a.asname or a.name] = f"{module}.{a.name}"
        elif module == KERNEL_PKG and self._check_kernels:
            for a in node.names:
                if a.name in RAW_KERNEL_MODULES \
                        and not self._line_has(node.lineno, KERNEL_PRAGMA):
                    self.kernel_imports.append((node.lineno, a.name))
        elif module:
            self._kernel_module(node, module)
        self.generic_visit(node)

    def _resolve(self, func) -> str:
        """The dotted ``torch.distributed`` callable a call target
        resolves to, or ''."""
        attrs = []
        while isinstance(func, ast.Attribute):
            attrs.append(func.attr)
            func = func.value
        if not isinstance(func, ast.Name):
            return ""
        attrs.reverse()
        if not attrs:
            return self.direct.get(func.id, "")
        if func.id in self.dist_aliases:
            return ".".join([self.dist_aliases[func.id]] + attrs)
        if func.id in self.direct:
            return ".".join([self.direct[func.id]] + attrs)
        if func.id in self.torch_aliases and attrs[0] == "distributed" \
                and len(attrs) > 1:
            return ".".join(["torch"] + attrs)
        return ""

    def visit_Call(self, node):
        name = self._resolve(node.func)
        if name and not self._line_has(node.lineno, PRAGMA):
            self.calls.append((node.lineno, name))
        self.generic_visit(node)


def _in_kernels_dir(path: str) -> bool:
    return KERNEL_ALLOWED_DIR in os.path.abspath(path)


def lint_file(path: str) -> List[AstFinding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [AstFinding(path=path, line=e.lineno or 0,
                           name=f"<syntax error: {e.msg}>")]
    check_collectives = not any(path.endswith(suf)
                                for suf in ALLOWED_SUFFIXES)
    v = _Visitor(src.splitlines(), _package_of(path),
                 check_kernels=not _in_kernels_dir(path))
    v.visit(tree)
    findings = []
    if check_collectives:
        findings += [AstFinding(path=path, line=ln, name=nm)
                     for ln, nm in v.calls]
    findings += [AstFinding(path=path, line=ln, name=nm, kind="kernel")
                 for ln, nm in v.kernel_imports]
    return sorted(findings, key=lambda f: f.line)


def lint_tree(root: str) -> List[AstFinding]:
    """Lint every ``.py`` under ``root``."""
    findings: List[AstFinding] = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            findings.extend(lint_file(os.path.join(dirpath, fn)))
    return findings


def default_root() -> str:
    """``src/repro_torch`` of the repo this module is installed from."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else default_root()
    findings = lint_tree(root)
    for f in findings:
        print(f)
    print(f"astlint: {len(findings)} finding(s) under {root}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
