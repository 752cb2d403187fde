"""Instruction counts of compiled kernels, from ``cuobjdump -sass``.

For each kernel of a shared library (or of a ``.cu`` source, built here
with the port's ``nvcc`` flags) whose name holds a pattern: its SASS
instructions, the instructions inside each loop (from a backward branch's
target to the branch), the subroutines it calls (``CALL``) with their
sizes, and its 64-bit integer divisions (each opens with the ``I2F.U64.RP``
of its reciprocal estimate, inline or in a called subroutine). Run on the
machine with the CUDA toolkit::

    python -m uemda_tpu_torch.kernels.sass segment_gather_kernel \\
        build/torch_ext/libsegment_*.so path/to/old/segment.cu
"""

import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_TARGET = re.compile(r"\b(BRA|CALL\.REL(?:\.NOINC)?)\b.*?0x([0-9a-f]+)")
_DIV64 = re.compile(r"\bI2F\.[US]64\.RP\b")


def parse(listing: str) -> Dict[str, dict]:
    """{kernel name: {"insns": n, "loops": [(start, end, n)], "calls":
    [subroutine size], "div64": n}} from a ``cuobjdump -sass`` listing."""
    funcs: Dict[str, List] = {}
    cur = None
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, insns in funcs.items():
        addrs = [a for a, _ in insns]
        loops, calls = [], []
        for a, text in insns:
            t = _TARGET.search(text)
            if not t:
                continue
            dst = int(t.group(2), 16)
            if t.group(1) == "BRA" and dst < a:
                loops.append((dst, a, sum(dst <= x <= a for x in addrs)))
            elif t.group(1).startswith("CALL"):
                end = next((x for x, s in insns if x >= dst and
                            any(w.startswith("RET") for w in s.split())),
                           addrs[-1])
                calls.append(sum(dst <= x <= end for x in addrs))
        out[name] = {"insns": len(insns), "loops": loops, "calls": calls,
                     "div64": sum(bool(_DIV64.search(t)) for _, t in insns)}
    return out


def library_of(path: str) -> str:
    """``path`` itself for a library; a ``.cu`` source is built first."""
    if not path.endswith(".cu"):
        return path
    from uemda_tpu_torch import kernels

    lib = Path(tempfile.mkdtemp()) / (Path(path).stem + ".so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                    path], check=True, capture_output=True)
    return str(lib)


def stats(path: str, pattern: str) -> Dict[str, dict]:
    """parse() of ``path``'s kernels whose name holds ``pattern``."""
    from uemda_tpu_torch import kernels

    tool = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    listing = subprocess.run([tool, "-sass", library_of(path)],
                             check=True, capture_output=True,
                             text=True).stdout
    return {k: v for k, v in parse(listing).items() if pattern in k}


def main(argv: List[str]) -> None:
    pattern, paths = argv[0], argv[1:]
    for path in paths:
        for name, s in stats(path, pattern).items():
            loops = ", ".join(f"{n} at {a:#x}-{b:#x}"
                              for a, b, n in s["loops"])
            print(f"{Path(path).name} {name}: {s['insns']} instructions; "
                  f"loops: {loops or 'none'}; calls: {s['calls'] or 'none'}; "
                  f"64-bit divisions: {s['div64']}")


if __name__ == "__main__":
    main(sys.argv[1:])
