"""Instruction counts of a built kernel, read from its SASS.

`disassemble` runs the toolkit's cuobjdump on a built library (on the
machine with the card: the CPU has no toolkit); `functions` splits the
listing into kernels and their instructions; `site_path` walks one kernel
from its entry to its exit along the path with the fewest float32
arithmetic instructions, which is the path of an ordinary site: it skips
the branches that only some sites take (the forcing guard of the columns
next to the y wrap, the slow path of an IEEE division) and the early exit
of threads past the lattice's end. Its counts are a site's instructions,
where the whole listing would count every branch once. `loops` gives the
opcodes inside each loop of a kernel, so that a probe's roll can be seen
to keep its stores and its barrier in the loop over rolls; `loop_path`
walks one loop's body along the same cheapest path, an ordinary site's
trip through a loop over sites (a temporal pass's level). `digests`
fingerprints each kernel's code, so that two builds' kernels can be
compared instruction for instruction.
"""

from __future__ import annotations

import collections
import hashlib
import heapq
import pathlib
import re
import subprocess

# the float32 pipe's arithmetic, and the special-function unit's
# reciprocal of the IEEE division's fast path
FP32 = ("FADD", "FMUL", "FFMA", "MUFU")

# "/*0a40*/  @!P1 BRA P2, 0x1260 ;" -> address, guard, opcode, operands
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")
_PRED_OPERAND = re.compile(r"(^|[\s,])!?U?P[0-6]\b")
# a mangled name in an anonymous namespace: the length of its identifier
_ANON = re.compile(r"_ZN(\d+)_GLOBAL__N_")
# the row of dots that closes a kernel's listing
_END = re.compile(r"^\s*\.{5,}\s*$", re.MULTILINE)
_BLANKS = re.compile(r"[ \t]+")


def disassemble(lib: str | pathlib.Path) -> str:
    """cuobjdump -sass of a built library, cuobjdump taken from beside
    nvcc."""
    from ..ops.cuda_build import find_nvcc

    tool = pathlib.Path(find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def functions(text: str) -> dict[str, list[tuple[int, bool, str, str]]]:
    """{mangled kernel name: [(address, guarded, opcode, operands), ...]}
    in address order; `guarded` is True for an instruction under a
    predicate other than PT."""
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        instrs = []
        for m in _INSTR.finditer(block):
            guard = m.group(2)
            instrs.append((int(m.group(1), 16), guard is not None and "PT" not in guard,
                           m.group(3), m.group(4).strip()))
        out[name] = instrs
    return out


def kernel_key(name: str) -> str:
    """A mangled kernel name without its anonymous namespace's identifier
    (_ZN<length>_GLOBAL__N__<tags>), which the compiler derives from the
    source it was built from: the kernel's own name and signature."""
    m = _ANON.match(name)
    return name[m.end(1) + int(m.group(1)):] if m else name


def digests(text: str) -> dict[str, str]:
    """{kernel_key(name): SHA-256 of the kernel's listing} for every
    kernel of a cuobjdump -sass listing: every instruction with its
    address, guard, operands and encoding, and the header flags, each run
    of blanks taken as one (cuobjdump pads every kernel of an object to
    the column of its widest instruction, so a kernel added beside another
    moves the other's padding). Two kernels with equal digests have the
    same SASS."""
    out = {}
    for block in text.split("Function : ")[1:]:
        name, body = (block.split("\n", 1) + [""])[:2]
        # the listing ends at its row of dots; what follows belongs to the
        # next object of the library
        body = _BLANKS.sub(" ", _END.split(body, 1)[0].strip())
        out[kernel_key(name.strip())] = hashlib.sha256(body.encode()).hexdigest()
    return out


def _successors(instrs, k, index):
    """Indices that can follow instruction k."""
    _, guarded, op, operands = instrs[k]
    base = op.split(".")[0]
    nxt = [k + 1] if k + 1 < len(instrs) else []
    if base == "EXIT":
        return nxt if guarded else []
    if base == "RET":
        return []
    if base == "BRA":
        target = index[int(_TARGET.search(operands).group(1), 16)]
        conditional = guarded or _PRED_OPERAND.search(operands) is not None
        return nxt + [target] if conditional else [target]
    # CALL (the division's slow path) returns to the next instruction; the
    # callee is left out: an ordinary site never calls it
    return nxt


def _cheapest_path(instrs, start, end, within=None) -> collections.Counter:
    """Opcode counts along the path from instruction index `start` to one
    that `end(k)` accepts with the fewest FP32 instructions, its steps kept
    to the indices `within(k)` accepts; None if no such path exists."""
    index = {addr: k for k, (addr, *_rest) in enumerate(instrs)}

    def weight(k):
        return int(instrs[k][2].split(".")[0] in FP32)

    best = {start: weight(start)}
    prev = {start: None}
    heap = [(best[start], start)]
    while heap:
        d, k = heapq.heappop(heap)
        if d > best[k]:
            continue
        if end(k):
            path = collections.Counter()
            while k is not None:
                path[instrs[k][2].split(".")[0]] += 1
                k = prev[k]
            return path
        for s in _successors(instrs, k, index):
            if within is not None and not within(s):
                continue
            ds = d + weight(s)
            if ds < best.get(s, ds + 1):
                best[s] = ds
                prev[s] = k
                heapq.heappush(heap, (ds, s))
    return None


def site_path(instrs: list[tuple[int, bool, str, str]]) -> collections.Counter:
    """Opcode counts (without modifiers: FADD, MUFU, LDG, ...) along the
    path from the first instruction to an unguarded EXIT with the fewest
    FP32 instructions; raises if no EXIT is reachable."""

    def is_exit(k):
        _, guarded, op, _ = instrs[k]
        return op.split(".")[0] == "EXIT" and not guarded

    path = _cheapest_path(instrs, 0, is_exit)
    if path is None:
        raise ValueError("no unguarded EXIT is reachable from the entry")
    return path


def loop_path(instrs: list[tuple[int, bool, str, str]], first: int, branch: int,
              through: str | None = None) -> collections.Counter:
    """Opcode counts along one trip through the loop from address `first`
    to its backward branch at address `branch` (an entry of `loops`): the
    path inside the loop from its first instruction to the branch with the
    fewest FP32 instructions, the branch included; with `through` (an
    opcode without modifiers, e.g. "MUFU"), the fewest among the paths that
    pass an instruction of that opcode (a fluid site's trip through a level
    whose solid sites branch around the collision and its division).
    Raises if no such path reaches the branch inside the loop."""
    index = {addr: k for k, (addr, *_rest) in enumerate(instrs)}
    k0, k1 = index[first], index[branch]

    def inside(k):
        return k0 <= k <= k1

    if through is None:
        path = _cheapest_path(instrs, k0, lambda k: k == k1, inside)
    else:
        path = None
        for m in range(k0, k1 + 1):
            if instrs[m][2].split(".")[0] != through:
                continue
            head = _cheapest_path(instrs, k0, lambda k, m=m: k == m, inside)
            tail = _cheapest_path(instrs, m, lambda k: k == k1, inside)
            if head is None or tail is None:
                continue
            both = head + tail
            both[through] -= 1  # the instruction ends one half and starts the other
            if path is None or (sum(both[x] for x in FP32) < sum(path[x] for x in FP32)):
                path = both
    if path is None:
        raise ValueError(f"the branch at {branch:#x} is not reachable inside its loop"
                         + (f" through a {through}" if through else ""))
    return path


def loops(instrs: list[tuple[int, bool, str, str]]) -> list[tuple[int, int, collections.Counter]]:
    """[(first address, branch address, opcode counts without modifiers)]
    for every backward branch of a kernel: the instructions from the
    branch's target to the branch itself, a loop's body (an outer loop's
    holds its inner loops). A branch to itself (the padding after the
    last EXIT) is not a loop."""
    index = {addr: k for k, (addr, *_rest) in enumerate(instrs)}
    out = []
    for k, (addr, _, op, operands) in enumerate(instrs):
        if op.split(".")[0] != "BRA":
            continue
        target = int(_TARGET.search(operands).group(1), 16)
        if target < addr:
            body = collections.Counter(i[2].split(".")[0] for i in instrs[index[target]: k + 1])
            out.append((target, addr, body))
    return out
