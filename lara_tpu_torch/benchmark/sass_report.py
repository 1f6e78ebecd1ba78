"""The SASS of the port's kernel library, per kernel: its local-memory loads
and stores (LDL, STL: register spills) and each loop (a branch back to an
earlier address) with its count of instructions and its commonest opcodes.
On the card, from the repository root::

    python -m lara_tpu_torch.benchmark.sass_report            # builds the library first
    python -m lara_tpu_torch.benchmark.sass_report --kernel wavefront_chain

``cuobjdump`` comes from the CUDA toolkit that builds the library.  The
report is read, not gated: a loop's count is what the compiler emitted,
not what a run issues (a branch skips part of a body)."""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BACK = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def _opcode(text: str) -> str:
    """The opcode of one instruction, its predicate and modifiers dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def report(sass: str) -> dict:
    """{kernel: {"instructions": n, "spills": LDL + STL,
    "loops": [(first address, last address, n, {opcode: count})]}} of the
    text of ``cuobjdump -sass``, each kernel's loops in address order."""
    kernels, name, code = {}, None, []

    def close():
        if name is None:
            return
        at = {addr: k for k, (addr, _) in enumerate(code)}
        loops = []
        for k, (addr, text) in enumerate(code):
            back = _BACK.search(text)
            if back and int(back.group(1), 16) <= addr \
                    and int(back.group(1), 16) in at:
                body = [t for _, t in code[at[int(back.group(1), 16)]:k + 1]]
                ops = collections.Counter(_opcode(t) for t in body)
                loops.append((int(back.group(1), 16), addr, len(body),
                              dict(ops.most_common(6))))
        kernels[name] = {
            "instructions": len(code),
            "spills": sum(_opcode(t) in ("LDL", "STL") for _, t in code),
            "loops": loops}

    for line in sass.splitlines():
        found = _FUNCTION.search(line)
        if found:
            close()
            name, code = found.group(1), []
            continue
        found = _INSTRUCTION.match(line)
        if found and name is not None:
            code.append((int(found.group(1), 16), found.group(2).strip()))
    close()
    return kernels


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", default="",
                        help="only kernels whose mangled name holds this")
    args = parser.parse_args(argv)
    from lara_tpu_torch import _build

    _build.library()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.LIBRARY], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    for name, got in report(sass).items():
        if args.kernel not in name:
            continue
        print(f"{name}: {got['instructions']} instructions, "
              f"{got['spills']} LDL/STL")
        for first, last, n, ops in got["loops"]:
            print(f"  loop {first:#x}..{last:#x}: {n} instructions {ops}")


if __name__ == "__main__":
    main()
