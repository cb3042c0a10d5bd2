"""Variants of a kernel's source for the tools that time them: text
substitutions on ``csrc`` files, one nvcc a library with the package's
flags (all started together), optionally the machine code of each, and a
block in which a wrapper launches a variant's entry point in place of the
package's build.

``ab_rollout``, ``ab_stoch_rollout``, ``b2_variants``, ``b11_variants`` and
``grid_variants`` build through ``build``. Run as a script it builds the
named sources from several ``csrc`` trees and prints each one's SASS hash
per tree, and whether the trees compile it to the same machine code:

    python -m safe_grid_agents_torch.tools.variants \\
        --sources stoch_rollout_kernel,tabular_stoch_kernel,ppo_stoch_collect_kernel \\
        --tree parent=_archive/parent/safe_grid_agents_torch/csrc \\
        --tree new=safe_grid_agents_torch/csrc [--out sass.json] [--functions]

``--functions`` prints a hash per kernel function instead, so that the
instantiation of a template can be held against the kernel it replaced.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from ..ops import _build


def substitute(text: str, changes, where: str) -> str:
    """``text`` with each ``(old, new)`` of ``changes`` replaced; raises if
    ``old`` is no longer in it (``where`` names the source)."""
    for old, new in changes:
        if old not in text:
            raise ValueError(f"{where} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def slug(label: str) -> str:
    return re.sub(r"[^A-Za-z0-9]+", "_", label).strip("_")


@dataclasses.dataclass(frozen=True)
class Built:
    so: Path            # the library
    report: str         # nvcc's output (the ``-Xptxas -v`` register report)
    sass: Optional[str] = None    # ``cuobjdump -sass`` of the library
    digest: Optional[str] = None  # hash of the SASS without the lines that name the file


def _cuobjdump(nvcc: str) -> str:
    return shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")


def _code(sass: str) -> str:
    """The SASS without the lines that name the file."""
    return "\n".join(line for line in sass.splitlines()
                     if not re.match(r"\s*(Fatbin|code for|arch|Function|=+|$)", line))


def functions(sass: str) -> dict:
    """``kernel -> SASS`` of each function's block."""
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def function_digests(sass: str) -> dict:
    """``kernel -> hash`` of each function's SASS (``_code`` of its block),
    so that one instantiation of a template can be held against the
    non-template kernel it replaced."""
    return {name: hashlib.sha256(_code(body).encode()).hexdigest()[:16]
            for name, body in functions(sass).items()}


def opcode_delta(a: str, b: str) -> dict:
    """``opcode -> count in b − count in a`` of two functions' SASS, the
    opcodes whose counts differ."""
    ca, cb = opcode_counts(a), opcode_counts(b)
    return {op: cb.get(op, 0) - ca.get(op, 0) for op in sorted(set(ca) | set(cb))
            if cb.get(op, 0) != ca.get(op, 0)}


def opcode_counts(sass: str) -> dict:
    """Instructions by opcode (the mnemonic before the first dot or space)."""
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass)
    return dict(collections.Counter(ops).most_common())


def registers(report: str) -> list:
    """The ``Used N registers ...`` lines of nvcc's report."""
    return re.findall(r"Used \d+ registers[^\n]*", report)


def build(sources: dict, out_dir: Path, flags=(), sass: bool = False) -> dict:
    """Compile every ``label -> .cu path`` into ``out_dir/lib<label>.so``,
    one nvcc each, all started together; returns ``label -> Built``. The
    source's own directory comes before the package's ``csrc`` on the
    include path, so a variant's headers beside it are the ones used.
    ``sass`` also reads each library's machine code. Raises with nvcc's
    output if a build fails."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for label, cu in sources.items():
        so = out_dir / f"lib{slug(label)}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(Path(cu).parent),
               "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), so)
    built = {}
    failed = []
    for label, (proc, so) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on variant {label}:\n{report}")
            continue
        code = digest = None
        if sass:
            code = subprocess.run([_cuobjdump(nvcc), "-sass", str(so)], capture_output=True,
                                  text=True, check=True).stdout
            digest = hashlib.sha256(_code(code).encode()).hexdigest()[:16]
        built[label] = Built(so, report, code, digest)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def write_variants(files, variants: dict, out_dir: Path, csrc: Path = _build.CSRC) -> dict:
    """Writes each variant of the files ``files`` of ``csrc`` (the
    package's by default) into a directory of its own under ``out_dir``;
    ``variants`` maps a name to its ``[(file, old, new), ...]``. Returns
    ``name -> {file: path}``. Every substitution is checked before anything
    is written."""
    texts = {f: (Path(csrc) / f).read_text() for f in files}
    changed = {}
    for name, changes in variants.items():
        srcs = dict(texts)
        for f, old, new in changes:
            srcs[f] = substitute(srcs[f], [(old, new)], str(Path(csrc) / f))
        changed[name] = srcs
    out_dir = Path(out_dir)
    if out_dir.exists():
        shutil.rmtree(out_dir)
    paths = {}
    for i, (name, srcs) in enumerate(changed.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True)
        for f, text in srcs.items():
            (d / f).write_text(text)
        paths[name] = {f: d / f for f in srcs}
    return paths


@contextlib.contextmanager
def swapped(module, **attrs):
    """Inside the block, ``module``'s attributes ``attrs`` (a wrapper's
    cached entry point) hold the given values; the old ones come back
    after."""
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def sass_digests(sources, trees: dict, out_dir: Path, by_function: bool = False) -> dict:
    """``source -> {label: SASS hash}`` of each ``csrc/<source>.cu`` of every
    ``label -> csrc directory`` of ``trees``, all built in parallel; with
    ``by_function``, ``{label: {kernel: {"hash", "instructions", "sass"}}}``
    (``function_digests``, the instruction count and the function's SASS)."""
    built = build({f"{label} {name}": Path(csrc) / f"{name}.cu"
                   for name in sources for label, csrc in trees.items()}, out_dir, sass=True)
    if by_function:
        out = {}
        for name in sources:
            out[name] = {}
            for label in trees:
                sass = built[f"{label} {name}"].sass
                digests = function_digests(sass)
                out[name][label] = {
                    fn: {"hash": digests[fn], "instructions": sum(opcode_counts(body).values()),
                         "sass": body}
                    for fn, body in functions(sass).items()}
        return out
    return {name: {label: built[f"{label} {name}"].digest for label in trees}
            for name in sources}


def _name_args(mangled: str):
    """``(function name, template arguments)`` of a mangled kernel name
    (``_ZN<len><ns>...<len><name>[I<args>E]...``); the anonymous namespace,
    whose hash differs between builds, is dropped."""
    at, parts = 3, []
    while at < len(mangled) and mangled[at].isdigit():
        digits = re.match(r"\d+", mangled[at:]).group()
        at += len(digits)
        parts.append(mangled[at:at + int(digits)])
        at += int(digits)
    args = ""
    if mangled[at:at + 1] == "I":
        args = re.match(r"I((?:L[^E]*E)*)E", mangled[at:]).group(1)
    return (parts[-1] if parts else mangled), args


def function_report(result: dict) -> list:
    """Lines of ``sass_digests(..., by_function=True)``'s result: each
    function's hash and instruction count, then, for each function of the
    first tree, the opcode counts that differ in every function of the
    other trees with its name whose template arguments extend its own (a
    template's instantiations) and whose hash differs. Drops the SASS text from the
    result, so that it can be written as JSON."""
    lines = []
    for name, digests in result.items():
        for label, fns in digests.items():
            for fn, f in fns.items():
                lines.append(f"{name} {label} {fn}: {f['hash']} ({f['instructions']} "
                             "instructions)")
        first, *rest = list(digests)
        for fn, f in digests[first].items():
            base, args = _name_args(fn)
            for label in rest:
                for gn, h in digests[label].items():
                    gbase, gargs = _name_args(gn)
                    if (gbase == base and gargs.startswith(args)
                            and h["hash"] != f["hash"]):
                        lines.append(f"{name} {first} {fn} -> {label} {gn}: opcode counts "
                                     f"{opcode_delta(f['sass'], h['sass'])}")
        for fns in digests.values():
            for f in fns.values():
                f.pop("sass", None)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SASS hashes of sources built from csrc trees")
    p.add_argument("--sources", required=True, help="comma-separated csrc/<name>.cu names")
    p.add_argument("--tree", action="append", required=True, help="label=csrc directory")
    p.add_argument("--out", default=None)
    p.add_argument("--functions", action="store_true",
                   help="a hash per kernel function (template instantiations apart)")
    args = p.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    result = sass_digests(args.sources.split(","), trees, _build.BUILD_DIR / "sass_check",
                          by_function=args.functions)
    if args.functions:
        for line in function_report(result):
            print(line, flush=True)
    else:
        for name, digests in result.items():
            same = "same machine code" if len(set(digests.values())) == 1 else "DIFFERENT code"
            print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in digests.items())
                  + f": {same}", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
