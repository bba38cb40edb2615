"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Counterpart of trino_tpu/ops/pallas_kernels.py and of the gather probe
in scripts/micro_probe.py.  Four kernels carry the TPC-H Q6/Q1/Q3 path:

  fused_agg_sums  (csrc/fused_agg.cu)     replaces `_fused_agg_kernel`
  grouped_count   (csrc/grouped_count.cu) replaces `_count_kernel`
  grouped_sum_i64 (csrc/grouped_sum.cu)   replaces `_plane_kernel`
  direct_probe    (csrc/direct_probe.cu)  replaces the VMEM gather probe

Each wrapper launches its kernel for CUDA tensors (or raises) and uses
the plain PyTorch version in this module only for CPU tensors.  Each
wrapper adds one to ``LAUNCHES[<wrapper name>]`` where it launches its
kernel, and nowhere else.  Inside an executor's supervision scope every
call crosses the device supervisor (runtime/supervisor.launch): a
breadcrumb names the wrapper and its input shapes, and the seeded
``device_loss`` / ``device_wedge`` fault sites are keyed by the
wrapper's name.

The kernels are built with nvcc for sm_90a into the build directory at
first use (trino_tpu_torch/build/, or the session's ``compile_cache_dir``:
``set_build_dir``), one nvcc per source, started together, and bound
through a plain C interface with ctypes.  Nothing is built at import
time.  Each nvcc run is a ``first_compile`` of the compile observatory,
each library found built by an earlier process a ``persistent_load``;
each launch's row count goes to the observatory's shape census.  The
fused kernel's encoded programs (``compile_program``) are held by the
process's compile cache (cache/compile_cache.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..obs import compile_observatory
from ..runtime import supervisor

MAX_GROUPS = 32   # shared accumulator table bound (as the TPU kernels)
# limits of csrc/fused_agg.cu's launch parameters (struct Params)
MAX_TERMS = 64    # kMaxTerms
MAX_COLS = 128    # kMaxCols: columns of one fused call
MAX_INS = 2048    # kMaxIns: encoded instructions
MAX_SLOTS = 255   # kMaxSlots: value slots (columns + temporaries)
# its shared memory: kR rows a thread, kStages tiles in flight, and the
# dynamic shared memory a block may opt in to on sm_90 (227 KiB)
FUSED_ROWS, FUSED_STAGES = 4, 2
SMEM_OPTIN = 232_448
# csrc/direct_probe.cu: rows a warp tile (32 lanes x kR) and warps a block
PROBE_TILE_ROWS, PROBE_WARPS = 256, 8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = {
    "fused_agg": "fused_agg.cu", "grouped_count": "grouped_count.cu",
    "grouped_sum": "grouped_sum.cu", "direct_probe": "direct_probe.cu",
}

# -- postfix program opcodes (csrc/fused_agg.cu enum Op) ---------------
LOAD, CONST, ADD, SUB, NEG, MUL, LO16, HI16 = range(8)
EQ, NE, LT, LE, GT, GE, AND, OR, NOT, CLIP = range(8, 18)
_BINARY = {ADD, SUB, MUL, EQ, NE, LT, LE, GT, GE, AND, OR}
_UNARY = {NEG, LO16, HI16, NOT, CLIP}
Code = Tuple[Tuple[int, int], ...]  # ((op, imm), ...)


@dataclasses.dataclass(frozen=True)
class Program:
    """What the fused kernel evaluates per row: a predicate (empty code =
    every live row), a group id (empty = group 0) and one value per
    aggregate term, each a postfix program over int32; LOAD's immediate
    indexes the kernel's column list."""

    pred: Code
    gid: Code
    terms: Tuple[Code, ...]


def stack_depth(code: Code) -> int:
    """Largest stack depth `code` reaches; raises on a malformed
    program (a pop from an empty stack, or not exactly one result)."""
    depth = best = 0
    for op, _imm in code:
        if op in (LOAD, CONST):
            depth += 1
        elif op in _BINARY:
            if depth < 2:
                raise ValueError("postfix program pops an empty stack")
            depth -= 1
        elif op in _UNARY:
            if depth < 1:
                raise ValueError("postfix program pops an empty stack")
        else:
            raise ValueError(f"unknown opcode {op}")
        best = max(best, depth)
    if code and depth != 1:
        raise ValueError("postfix program must leave exactly one value")
    return best


def check_program(prog: Program, n_cols: int, groups: int) -> "Encoded":
    """Raise ValueError unless the kernel can run `prog` as given;
    returns its encoding."""
    if not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"groups {groups} outside [1, {MAX_GROUPS}]")
    if not 1 <= len(prog.terms) <= MAX_TERMS:
        raise ValueError(f"{len(prog.terms)} terms outside [1, {MAX_TERMS}]")
    if n_cols > MAX_COLS:
        raise ValueError(f"{n_cols} columns, the launch takes {MAX_COLS}")
    codes = (prog.pred, prog.gid) + tuple(prog.terms)
    for i, c in enumerate(codes):
        if i >= 2 and not c:
            raise ValueError("a term program is empty")
        stack_depth(c)  # raises on a malformed program
        for op, imm in c:
            if op == LOAD and not 0 <= imm < n_cols:
                raise ValueError(f"LOAD of column {imm} of {n_cols}")
            if op == CONST and not -(2**31) <= imm < 2**31:
                raise ValueError(f"constant {imm} outside int32")
            if op == CLIP and not 1 <= imm < 2**31:
                raise ValueError("CLIP domain must be positive")
    enc = encode(prog)
    if len(enc.ins) > MAX_INS:
        raise ValueError(f"{len(enc.ins)} encoded instructions, the kernel "
                         f"takes {MAX_INS}")
    if enc.n_slots > MAX_SLOTS:
        raise ValueError(f"{enc.n_slots} value slots, the kernel has {MAX_SLOTS}")
    # the lanes' element sizes are not known here: count each column read
    # as int64 and every column with a validity lane
    lane_bytes = 8 * len(enc.col_slots) + n_cols + 1
    need = fused_smem_bytes(32, enc.n_slots, lane_bytes, len(prog.terms), groups)
    if need > SMEM_OPTIN:
        raise ValueError(f"{need} bytes of shared memory at 32 threads a block, "
                         f"the card has {SMEM_OPTIN}")
    return enc


@dataclasses.dataclass(frozen=True, eq=False)
class Compiled(Program):
    """A Program checked for the kernel (check_program) and encoded, for
    `n_cols` columns and `groups` groups: what the compile cache holds and
    what the fused wrapper launches.  It is the Program itself (equal
    codes, equal hash), with its encoding beside it."""

    n_cols: int = 0
    groups: int = 0
    encoded: Optional["Encoded"] = None
    words: object = None  # ctypes int32 array of encoded.words()

    @property
    def program(self) -> Program:
        return Program(self.pred, self.gid, self.terms)


def compile_program(prog: Program, n_cols: int, groups: int) -> Compiled:
    """Check and encode `prog` for `n_cols` columns and `groups` groups
    (raises ValueError where the kernel cannot run it).  Uncached: the
    callers go through cache/compile_cache.CompileCache.program."""
    enc = check_program(prog, n_cols, groups)
    return Compiled(prog.pred, prog.gid, prog.terms, n_cols, groups, enc,
                    _words(enc))


def fused_smem_bytes(threads: int, n_slots: int, lane_bytes: int, n_terms: int,
                     groups: int) -> int:
    """Dynamic shared memory of one block of csrc/fused_agg.cu (its
    fill_and_launch): the value slots, kStages tiles of every lane
    (`lane_bytes` = the lanes' element sizes summed) and the accumulators."""
    per_thread = (n_slots * FUSED_ROWS * 4 + FUSED_STAGES * FUSED_ROWS * lane_bytes
                  + (n_terms * 8 if groups == 1 else 0))
    return threads * per_thread + (0 if groups == 1 else n_terms * groups * 8)


# -- straight-line encoding (csrc/fused_agg.cu) --------------------------
#
# The kernel does not interpret the postfix code.  `encode` compiles a
# Program into one straight-line list of instructions with explicit
# operands: constants folded (int32 wrap), common subexpressions shared
# across the predicate, the group id and every term (where that keeps at
# most MAX_SLOTS values live), the predicate's top-level conjuncts ANDed
# into a row mask one by one, and every value in a slot chosen here
# (columns take slots 0.., temporaries the rest, reused once dead), so
# the kernel keeps no stack.
#
# An instruction is (op, flags, dst, a, b): a is a slot; b is a slot, or
# the immediate when flags has F_IMM; binary ops compute a op b, unary
# ops and MOV read b; CLIP clamps a to [0, b - 1]; ACC adds b to term dst
# for the rows of the mask.  F_MASK ANDs (result != 0) into the row mask;
# dst NO_DST keeps the result nowhere else.  The first n_pre instructions
# (predicate and group id) run for every row; the rest (terms) only in
# warps where some row passed.

RSUB, MOV, ACC = 18, 19, 20   # kernel-only opcodes: b - a, copy, accumulate
F_IMM, F_MASK = 1, 2
NO_DST = 255
_COMMUTE = {ADD, MUL, EQ, NE, AND, OR}
_MIRROR = {SUB: RSUB, LT: GT, LE: GE, GT: LT, GE: LE}  # k op x == x op' k


def _wrap(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _fold(op: int, a: int, b: int = 0) -> int:
    """`op` on int32 constants, wrapping as the kernel and torch do."""
    if op == ADD:
        return _wrap(a + b)
    if op == SUB:
        return _wrap(a - b)
    if op == RSUB:
        return _wrap(b - a)
    if op == MUL:
        return _wrap(a * b)
    if op == NEG:
        return _wrap(-a)
    if op == LO16:
        return a & 0xFFFF
    if op == HI16:
        return a >> 16
    if op == NOT:
        return int(a == 0)
    if op == CLIP:
        return min(max(a, 0), b - 1)
    return int({
        EQ: a == b, NE: a != b, LT: a < b, LE: a <= b, GT: a > b, GE: a >= b,
        AND: a != 0 and b != 0, OR: a != 0 or b != 0,
    }[op])


@dataclasses.dataclass(frozen=True)
class Encoded:
    """A Program as csrc/fused_agg.cu runs it (see the note above)."""

    ins: Tuple[Tuple[int, int, int, int, int], ...]  # (op, flags, dst, a, b)
    n_pre: int                                       # predicate + group id
    gid: Tuple[int, int]                             # (flags, slot or immediate)
    col_slots: Tuple[Tuple[int, int], ...]           # (column, slot) read
    n_slots: int

    def words(self) -> List[int]:
        """Two int32 words an instruction, as the kernel decodes them."""
        out: List[int] = []
        for op, fl, dst, a, b in self.ins:
            out += [op | fl << 8 | dst << 16 | a << 24, b]
        return out


class _Values:
    """Value numbering with constant folding.  A value is ("k", v) for an
    int32 constant or an int id of a node: ("col", k) or (op, x, y), with
    a constant, if any, always in y (commuted or mirrored there).  Without
    `share`, every operation is a node of its own, its operands in postfix
    order."""

    def __init__(self, share: bool):
        self.share = share
        self.ids: Dict[tuple, int] = {}
        self.node: List[tuple] = []

    def _id(self, key: tuple) -> int:
        i = self.ids.get(key)
        if i is None or not (self.share or key[0] == "col"):
            i = self.ids[key] = len(self.node)
            self.node.append(key)
        return i

    def col(self, k: int) -> int:
        return self._id(("col", k))

    def apply(self, op: int, x, y=None):
        xk, yk = isinstance(x, tuple), isinstance(y, tuple)
        if y is None:
            return ("k", _fold(op, x[1])) if xk else self._id((op, x, None))
        if xk and yk:
            return ("k", _fold(op, x[1], y[1]))
        if xk:
            x, y = y, x
            op = op if op in _COMMUTE else _MIRROR[op]
        elif self.share and op in _COMMUTE and not yk and y < x:
            x, y = y, x
        return self._id((op, x, y))

    def tree(self, code: Code):
        st: list = []
        for op, imm in code:
            if op == LOAD:
                st.append(self.col(imm))
            elif op == CONST:
                st.append(("k", _wrap(imm)))
            elif op == CLIP:
                st.append(self.apply(CLIP, st.pop(), ("k", imm)))
            elif op in _UNARY:
                st.append(self.apply(op, st.pop()))
            else:
                b = st.pop()
                st.append(self.apply(op, st.pop(), b))
        return st[-1]

    def conjuncts(self, v, out: list) -> None:
        if not isinstance(v, tuple) and self.node[v][0] == AND:
            self.conjuncts(self.node[v][1], out)
            self.conjuncts(self.node[v][2], out)
        elif v not in out:
            out.append(v)


def encode(prog: Program) -> Encoded:
    """Compile a well-formed Program (check_program) for the kernel, its
    common subexpressions shared unless that keeps more than MAX_SLOTS
    values live; then each program is evaluated on its own, in postfix
    order, with no more temporaries than its stack depth."""
    enc = _encode(prog, share=True)
    return enc if enc.n_slots <= MAX_SLOTS else _encode(prog, share=False)


def _encode(prog: Program, share: bool) -> Encoded:
    vals = _Values(share)
    # [op, flags, value defined (or None), a (or None), b, term (ACC)]
    code: List[list] = []
    at: Dict[int, int] = {}

    def emit(v) -> None:
        if v is None or isinstance(v, tuple) or v in at or vals.node[v][0] == "col":
            return
        op, x, y = vals.node[v]
        emit(x)
        emit(y)
        at[v] = len(code)
        code.append([op, 0, v, None, x, 0] if y is None else [op, 0, v, x, y, 0])

    conj: list = []
    if prog.pred:
        vals.conjuncts(vals.tree(prog.pred), conj)
    for c in conj:
        if isinstance(c, tuple):
            if c[1] == 0:  # never true
                code.append([MOV, F_MASK, None, None, c, 0])
        elif c in at or vals.node[c][0] == "col":
            code.append([MOV, F_MASK, None, None, c, 0])
        else:
            emit(c)
            code[at[c]][1] |= F_MASK
    gid = vals.tree(prog.gid) if prog.gid else ("k", 0)
    emit(gid)
    n_pre = len(code)
    for t, tc in enumerate(prog.terms):
        v = vals.tree(tc)
        emit(v)
        code.append([ACC, 0, None, None, v, t])

    def operands(a, b):
        return {x for x in (a, b) if x is not None and not isinstance(x, tuple)}

    # register allocation: the last use of every value decides when its
    # slot is free again; the group id stays live up to the mask point
    last: Dict[int, float] = {}
    for i, (_op, _fl, _v, a, b, _t) in enumerate(code):
        for x in operands(a, b):
            last[x] = i
    if not isinstance(gid, tuple):
        last[gid] = max(last.get(gid, -1), n_pre - 0.5)
    cols = sorted(vals.node[v][1] for v in last if vals.node[v][0] == "col")
    slot = {vals.col(k): s for s, k in enumerate(cols)}
    free: List[int] = []
    top = len(cols)

    def release(v) -> None:
        if vals.node[v][0] != "col":
            free.append(slot[v])
            free.sort()

    out = []
    for i, (op, fl, v, a, b, t) in enumerate(code):
        if i == n_pre and not isinstance(gid, tuple) and last[gid] < i:
            release(gid)
        for x in operands(a, b):
            if last[x] == i:
                release(x)
        if op == ACC:
            dst = t
        elif v is not None and last.get(v, -1) > i:
            if free:
                slot[v] = free.pop(0)
            else:
                slot[v] = top
                top += 1
            dst = slot[v]
        else:
            dst = NO_DST
        bk = isinstance(b, tuple)
        out.append((op, fl | (F_IMM if bk else 0), dst,
                    0 if a is None else slot[a], b[1] if bk else slot[b]))
    g = (F_IMM, gid[1]) if isinstance(gid, tuple) else (0, slot[gid])
    return Encoded(tuple(out), n_pre, g,
                   tuple((k, s) for s, k in enumerate(cols)), top)


# -- plain versions -----------------------------------------------------


def _run_plain(code: Code, cols: Sequence[torch.Tensor], live: torch.Tensor) -> torch.Tensor:
    """Evaluate one postfix program over whole int32 columns (wrapping
    int32 arithmetic; comparisons and logic give 0/1)."""
    st: List[torch.Tensor] = []
    for op, imm in code:
        if op == LOAD:
            st.append(cols[imm].to(torch.int32))
        elif op == CONST:
            st.append(torch.full(live.shape, imm, dtype=torch.int32, device=live.device))
        elif op in _BINARY:
            b = st.pop()
            a = st.pop()
            if op == ADD:
                r = a + b
            elif op == SUB:
                r = a - b
            elif op == MUL:
                r = a * b
            elif op == EQ:
                r = a == b
            elif op == NE:
                r = a != b
            elif op == LT:
                r = a < b
            elif op == LE:
                r = a <= b
            elif op == GT:
                r = a > b
            elif op == GE:
                r = a >= b
            elif op == AND:
                r = (a != 0) & (b != 0)
            else:  # OR
                r = (a != 0) | (b != 0)
            st.append(r.to(torch.int32))
        else:
            a = st.pop()
            if op == NEG:
                r = -a
            elif op == LO16:
                r = a & 0xFFFF
            elif op == HI16:
                r = a >> 16
            elif op == NOT:
                r = (a == 0).to(torch.int32)
            else:  # CLIP
                r = torch.clamp(a, 0, imm - 1)
            st.append(r)
    return st[-1]


def fused_agg_sums_plain(
    cols: Sequence[torch.Tensor], valids: Sequence[Optional[torch.Tensor]],
    live: torch.Tensor, prog: Program, groups: int,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: each column narrowed to
    int32 as `.to(torch.int32)` narrows, every validity lane ANDed into
    `live`, the postfix programs over whole columns, then exact int64
    per-(term, group) sums.  Returns int64 [n_terms, groups]."""
    n = live.shape[0]
    dev = live.device
    mask = live.to(torch.bool)
    for ok in valids:
        if ok is not None:
            mask = mask & ok
    cols = [c.to(torch.int32) for c in cols]
    if prog.pred:
        mask = mask & (_run_plain(prog.pred, cols, live) != 0)
    if prog.gid:
        gid = _run_plain(prog.gid, cols, live).to(torch.int64)
        mask = mask & (gid >= 0) & (gid < groups)
    else:
        gid = torch.zeros(n, dtype=torch.int64, device=dev)
    g = gid[mask]
    out = torch.zeros((len(prog.terms), groups), dtype=torch.int64, device=dev)
    for t, code in enumerate(prog.terms):
        v = _run_plain(code, cols, live).to(torch.int64)
        out[t].index_add_(0, g, v[mask])
    return out


def grouped_count_plain(
    flags: torch.Tensor, gid: torch.Tensor, cap: int
) -> torch.Tensor:
    """Plain PyTorch version of the grouped count: int64 [cap] counts
    of set flags per group id; ids outside [0, cap) are skipped."""
    g = gid.to(torch.int64)
    m = flags.to(torch.bool) & (g >= 0) & (g < cap)
    out = torch.zeros(cap, dtype=torch.int64, device=flags.device)
    return out.index_add_(0, g[m], torch.ones_like(g[m]))


def grouped_sum_i64_plain(
    values: torch.Tensor, gid: torch.Tensor, cap: int
) -> torch.Tensor:
    """Plain PyTorch version of the grouped int64 sum: int64 [cap] sums
    (wrapping mod 2^64) of `values` per group id; ids outside [0, cap)
    are skipped."""
    g = gid.to(torch.int64)
    m = (g >= 0) & (g < cap)
    out = torch.zeros(cap, dtype=torch.int64, device=values.device)
    return out.index_add_(0, g[m], values.to(torch.int64)[m])


def direct_probe_plain(
    table: torch.Tensor, key: torch.Tensor, ok: torch.Tensor,
    sel: torch.Tensor, lo: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the direct-address probe (the function of
    trino_tpu/ops/join.py probe_direct): (build row int64 [n], matched
    bool [n]) for an int32 table of build row + 1 (0 = empty)."""
    domain = table.shape[0]
    kv = key.to(torch.int64) - lo
    in_dom = (kv >= 0) & (kv < domain)
    slot = table[torch.clamp(kv, 0, domain - 1)]
    matched = sel & ok & in_dom & (slot > 0)
    return (slot - 1).to(torch.int64), matched


# -- build and binding --------------------------------------------------

# loaded libraries by path (the build directory can change: set_build_dir)
_LIBS: Dict[str, ctypes.CDLL] = {}
# one build and one load of a library a process: the threads of one
# process (a worker's tasks, two in-process workers on one card) that
# first touch a kernel together wait here for the first to finish
_BUILD_LOCK = threading.RLock()
# per-thread launch counts of the calling task (counting_launches)
_TASK_COUNTS = threading.local()
LAUNCHES: Dict[str, int] = {
    "fused_agg_sums": 0, "grouped_count": 0, "grouped_sum_i64": 0,
    "direct_probe": 0,
}
_BUILD_DIR = [BUILD]
# library paths this process has built or adopted (each is one ledger
# event of the compile observatory)
_RECORDED: set = set()


def _launched(name: str, n: int) -> None:
    """Count one launch of a kernel and its rows (a Python int: nothing
    reads the card) into the observatory's shape census."""
    LAUNCHES[name] += 1
    counts = getattr(_TASK_COUNTS, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
    compile_observatory.get_observatory().observe_launch(name, n)


class counting_launches:
    """Count the launches the calling thread makes while open, apart
    from the process-wide LAUNCHES (a worker's task: other tasks of the
    process launch on their own threads at the same time).  ``counts``
    is {wrapper name: launches}."""

    def __enter__(self) -> Dict[str, int]:
        self._prev = getattr(_TASK_COUNTS, "counts", None)
        self.counts: Dict[str, int] = {}
        _TASK_COUNTS.counts = self.counts
        return self.counts

    def __exit__(self, *exc) -> None:
        _TASK_COUNTS.counts = self._prev


def build_dir() -> str:
    return _BUILD_DIR[0]


def set_build_dir(path: Optional[str]) -> None:
    """Build and load the libraries in `path` from now on (the session's
    compile_cache_dir), or in the package's build directory when empty."""
    _BUILD_DIR[0] = os.path.abspath(path) if path else BUILD


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def _record_build(name: str, cause: str, wall_s: float) -> None:
    compile_observatory.record_compile(
        kernel=f"lib{name}.so", family=f"nvcc:{SOURCES[name]}", cause=cause,
        mode="nvcc", shapes={"arch": "sm_90a", "source": SOURCES[name]},
        compile_wall_s=wall_s, scan_rows=[],
    )


def build(verbose: bool = False) -> Dict[str, str]:
    """Compile every kernel source that is missing or older than its
    library in the build directory, one nvcc per source, all started
    together.  Returns {name: ptxas report} for the sources compiled now.
    Each nvcc run is recorded as a first_compile, each library already
    built by an earlier process as a persistent_load (once a process).
    One thread of a process builds at a time."""
    with _BUILD_LOCK:
        return _build(verbose)


def _build(verbose: bool) -> Dict[str, str]:
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        path = os.path.join(CSRC, src)
        out = _lib_path(name)
        if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(path):
            if out not in _RECORDED:
                _RECORDED.add(out)
                _record_build(name, compile_observatory.PERSISTENT_LOAD, 0.0)
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", tmp, path,
        ]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {}
    for name, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{text}")
        os.replace(tmp, out)
        _RECORDED.add(out)
        _record_build(name, compile_observatory.FIRST_COMPILE,
                      time.perf_counter() - t0)
        reports[name] = text
        if verbose:
            print(text)
    return reports


def _lib(name: str) -> ctypes.CDLL:
    path = _lib_path(name)
    lib = _LIBS.get(path)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LIBS.get(path)
        if lib is None:
            build()
            lib = _LIBS[path] = _bind(name, ctypes.CDLL(path))
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a library's launchers."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "fused_agg":
        lib.fused_agg_sums_launch.argtypes = [P, I, L, P, I, I, I, I, I, I, I, P, P]
        lib.fused_agg_sums_launch.restype = I
    elif name == "grouped_count":
        lib.grouped_count_launch.argtypes = [P, P, L, I, P, P]
        lib.grouped_count_launch.restype = I
    elif name == "grouped_sum":
        lib.grouped_sum_launch.argtypes = [P, P, L, I, P, P]
        lib.grouped_sum_launch.restype = I
    else:
        lib.direct_probe_launch.argtypes = [P, L, P, I, P, P, L, L, P, P, I, P]
        lib.direct_probe_launch.restype = I
        lib.direct_probe_grid.argtypes = [I, ctypes.POINTER(I)]
        lib.direct_probe_grid.restype = I
    return lib


def probe_blocks(n: int, grid: int) -> int:
    """Persistent grid of csrc/direct_probe.cu for n probe rows: one warp
    a tile of PROBE_TILE_ROWS rows, PROBE_WARPS warps a block, at most the
    card's `grid` blocks (_probe_grid), at least one."""
    tiles = -(-n // PROBE_TILE_ROWS)
    return max(1, min(grid, -(-tiles // PROBE_WARPS)))


def aligned_lane(t: torch.Tensor) -> torch.Tensor:
    """`t` itself, or a contiguous copy where it starts off 16 bytes or
    is not contiguous (a copy starts at the allocator's alignment): the
    kernels copy whole 16-byte chunks of their streams."""
    if t.data_ptr() % 16 or (t.shape[0] > 1 and t.stride(0) != 1):
        return t.clone(memory_format=torch.contiguous_format)
    return t


_PROBE_GRID: Dict[int, int] = {}


def _probe_grid(index: int) -> int:
    """The direct probe's full grid on card `index` (its launcher's
    blocks an SM times the SMs), asked once a card."""
    got = _PROBE_GRID.get(index)
    if got is None:
        blocks = ctypes.c_int(0)
        _check_rc(_lib("direct_probe").direct_probe_grid(index, ctypes.byref(blocks)),
                  "direct_probe grid query")
        got = _PROBE_GRID[index] = blocks.value
    return got


# the current CUDA stream of a card as an int: PyTorch's raw query where
# it has one (no Stream object built), else the public one
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


# the sticky cudaErrors a launch can report (a fault of earlier work: the
# process's CUDA context is lost), in the runtime's words, which the
# device supervisor reads as a loss; any other code is a bad argument or
# launch configuration and fails the query alone
_STICKY_ERRORS = {
    46: "CUDA-capable device(s) is/are busy or unavailable",
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    710: "device-side assert triggered",
    719: "unspecified launch failure",
}


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        sticky = _STICKY_ERRORS.get(rc)
        raise RuntimeError(f"{what} launch failed: cudaError {rc}"
                           + (f" ({sticky})" if sticky else ""))


# -- wrappers -----------------------------------------------------------


def _words(enc: Encoded):
    """The launch parameter of an encoding: its int32 words."""
    words = enc.words()
    return (ctypes.c_int * max(len(words), 1))(*words)


def fused_agg_sums(
    cols: Sequence[torch.Tensor], valids: Sequence[Optional[torch.Tensor]],
    live: torch.Tensor, prog, groups: int,
) -> torch.Tensor:
    """Fused scan->filter->aggregate: exact int64 per-(term, group) sums,
    [n_terms, groups], over the lanes as the scan holds them.  `cols` are
    int32 or int64 [n] columns, narrowed to int32 as `.to(torch.int32)`
    narrows (LOAD k reads cols[k]); `valids` holds each column's bool [n]
    validity lane or None; `live` is a bool [n] mask.  A row counts where
    live, every validity lane and the predicate hold and its group id
    lies in [0, groups).  `prog` is a Program (checked and encoded
    through the process's compile cache) or the Compiled a cache gave
    for these columns and groups.  On the card the encoded program and
    the lane pointers travel in the launch's parameters: no copy, no
    host sync."""
    if isinstance(prog, Compiled):
        comp = prog
        if comp.n_cols != len(cols) or comp.groups != groups:
            raise ValueError("the compiled program was checked for "
                             f"{comp.n_cols} columns and {comp.groups} groups")
    else:
        from ..cache.compile_cache import shared_compile_cache

        comp = shared_compile_cache().program(prog, len(cols), groups)
    n = live.shape[0]
    if live.dtype != torch.bool or live.dim() != 1:
        raise ValueError("live must be a 1-D bool tensor")
    if len(valids) != len(cols):
        raise ValueError("one validity lane (or None) per column")
    for c in cols:
        if (c.dtype not in (torch.int32, torch.int64) or c.shape != (n,)
                or c.device != live.device):
            raise ValueError("columns must be int32 or int64 [n] on live's device")
    for ok in valids:
        if ok is not None and (ok.dtype != torch.bool or ok.shape != (n,)
                               or ok.device != live.device):
            raise ValueError("validity lanes must be bool [n] on live's device")
    if live.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {live.device}")
    shapes = {"live": live, "terms": len(comp.terms), "groups": groups}
    shapes.update((f"col{k}", c) for k, c in enumerate(cols))
    return supervisor.launch(
        "fused_agg_sums",
        lambda: _fused_agg_sums(cols, valids, live, comp, groups), shapes)


def _fused_agg_sums(cols, valids, live, comp: Compiled, groups):
    if live.device.type == "cpu":
        return fused_agg_sums_plain(cols, valids, live, comp, groups)
    n = live.shape[0]
    enc = comp.encoded
    # a lane that starts off 16 bytes is copied (the copies live until the
    # launch is queued behind them)
    values = [(aligned_lane(cols[k]), s) for k, s in enc.col_slots]
    masks = [aligned_lane(ok) for ok in list(valids) + [live] if ok is not None]
    lanes: List[int] = []
    for c, s in values:
        lanes += [c.data_ptr(), c.element_size(), s]
    for ok in masks:
        lanes += [ok.data_ptr(), 1, -1]
    dev = live.device
    lib = _lib("fused_agg")
    out = torch.zeros((len(comp.terms), groups), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_agg_sums_launch(
        (ctypes.c_longlong * len(lanes))(*lanes), len(lanes) // 3, n,
        comp.words, len(enc.ins), enc.n_pre, enc.gid[0], enc.gid[1],
        enc.n_slots, len(comp.terms), groups, out.data_ptr(), stream,
    )
    _check_rc(rc, "fused_agg_sums")
    _launched("fused_agg_sums", n)
    return out


def grouped_count(flags: torch.Tensor, gid: torch.Tensor, cap: int) -> torch.Tensor:
    """Exact int64 per-group count of set flags, [cap]; group ids
    outside [0, cap) are skipped."""
    if flags.dim() != 1 or gid.shape != flags.shape:
        raise ValueError("flags and gid must be matching 1-D tensors")
    if not 1 <= cap <= MAX_GROUPS:
        raise ValueError(f"cap {cap} outside [1, {MAX_GROUPS}]")
    if flags.device != gid.device:
        raise ValueError("flags and gid lie on different devices")
    if flags.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flags.device}")
    if flags.device.type == "cuda" and (
            flags.dtype not in (torch.bool, torch.uint8) or gid.dtype != torch.int64):
        raise ValueError("grouped_count takes bool flags and int64 gid")
    return supervisor.launch(
        "grouped_count", lambda: _grouped_count(flags, gid, cap),
        {"flags": flags, "gid": gid, "cap": cap})


def _grouped_count(flags, gid, cap):
    if flags.device.type == "cpu":
        return grouped_count_plain(flags, gid, cap)
    flags = flags.contiguous()
    gid = gid.contiguous()
    # the kernel reads each id pair's two flags as one 2-byte word after
    # a one-row head that aligns the ids to 16 bytes: where the flags
    # then lie at an odd address, copy the stream that is off (a copy
    # starts at the allocator's alignment)
    head = gid.data_ptr() % 16 != 0
    if (flags.data_ptr() + head) % 2:
        if head:
            gid = gid.clone()
        else:
            flags = flags.clone()
    dev = flags.device
    lib = _lib("grouped_count")
    n = flags.shape[0]
    out = torch.zeros(cap, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.grouped_count_launch(
        flags.data_ptr(), gid.data_ptr(), n, cap, out.data_ptr(), stream,
    )
    _check_rc(rc, "grouped_count")
    _launched("grouped_count", n)
    return out


def grouped_sum_i64(values: torch.Tensor, gid: torch.Tensor, cap: int) -> torch.Tensor:
    """Exact int64 per-group sum of `values`, [cap], wrapping mod 2^64;
    group ids outside [0, cap) are skipped."""
    if values.dim() != 1 or gid.shape != values.shape:
        raise ValueError("values and gid must be matching 1-D tensors")
    if not 1 <= cap <= MAX_GROUPS:
        raise ValueError(f"cap {cap} outside [1, {MAX_GROUPS}]")
    if values.device != gid.device:
        raise ValueError("values and gid lie on different devices")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {values.device}")
    if values.device.type == "cuda" and (
            values.dtype != torch.int64 or gid.dtype != torch.int64):
        raise ValueError("grouped_sum_i64 takes int64 values and int64 gid")
    return supervisor.launch(
        "grouped_sum_i64", lambda: _grouped_sum_i64(values, gid, cap),
        {"values": values, "gid": gid, "cap": cap})


def _grouped_sum_i64(values, gid, cap):
    if values.device.type == "cpu":
        return grouped_sum_i64_plain(values, gid, cap)
    values = values.contiguous()
    gid = gid.contiguous()
    # the kernel reads both streams in 16-byte vectors after one common
    # head row, so they must share their 16-byte phase: where they do
    # not, copy the one that is off (a copy starts at the allocator's
    # alignment)
    if (values.data_ptr() - gid.data_ptr()) % 16:
        if values.data_ptr() % 16:
            values = values.clone()
        else:
            gid = gid.clone()
    dev = values.device
    lib = _lib("grouped_sum")
    n = values.shape[0]
    out = torch.zeros(cap, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.grouped_sum_launch(
        values.data_ptr(), gid.data_ptr(), n, cap, out.data_ptr(), stream,
    )
    _check_rc(rc, "grouped_sum_i64")
    _launched("grouped_sum_i64", n)
    return out


def direct_probe(
    table: torch.Tensor, key: torch.Tensor, ok: torch.Tensor,
    sel: torch.Tensor, lo: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-address join probe: (build row int64 [n], matched bool [n])
    from an int32 [domain] table of build row + 1 (0 = empty slot),
    int64 or int32 probe keys, their validity `ok` and the probe side's
    selection `sel`; `lo` is the key the table's slot 0 stands for.  On
    the card a key, ok or sel lane that starts off 16 bytes is copied
    first (aligned_lane); the launch needs no host sync."""
    n = key.shape[0]
    if table.dim() != 1 or table.dtype != torch.int32 or table.shape[0] < 1:
        raise ValueError("table must be a non-empty 1-D int32 tensor")
    if key.dim() != 1 or key.dtype not in (torch.int64, torch.int32):
        raise ValueError("key must be a 1-D int64 or int32 tensor")
    if (ok.dtype != torch.bool or sel.dtype != torch.bool or ok.shape != key.shape
            or sel.shape != key.shape):
        raise ValueError("ok and sel must be bool tensors shaped like key")
    if not -(2**63) <= lo < 2**63:
        raise ValueError("lo outside int64")
    # the card's index, -1 off the card: ints, cheaper than device objects
    # on a path whose host time the card waits for
    d = key.get_device()
    if d < 0:
        dev = key.device
        if table.device != dev or ok.device != dev or sel.device != dev:
            raise ValueError("table, key, ok and sel lie on different devices")
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
    elif table.get_device() != d or ok.get_device() != d or sel.get_device() != d:
        raise ValueError("table, key, ok and sel lie on different devices")
    return supervisor.launch(
        "direct_probe", lambda: _direct_probe(table, key, ok, sel, lo, d),
        {"table": table, "key": key, "lo": lo})


def _direct_probe(table, key, ok, sel, lo, d):
    if d < 0:
        return direct_probe_plain(table, key, ok, sel, lo)
    n = key.shape[0]
    table = table.contiguous()
    key, ok, sel = aligned_lane(key), aligned_lane(ok), aligned_lane(sel)
    lib = _lib("direct_probe")
    blocks = probe_blocks(n, _probe_grid(d))
    row = torch.empty(n, dtype=torch.int64, device=key.device)
    matched = torch.empty(n, dtype=torch.bool, device=key.device)
    rc = lib.direct_probe_launch(
        table.data_ptr(), table.shape[0], key.data_ptr(), key.element_size(),
        ok.data_ptr(), sel.data_ptr(), lo, n, row.data_ptr(),
        matched.data_ptr(), blocks, _current_stream(d),
    )
    _check_rc(rc, "direct_probe")
    _launched("direct_probe", n)
    return row, matched


def seg_count_maybe(flags: torch.Tensor, gid: torch.Tensor, cap: int):
    """Kernel-or-None per-group count of 0/1 flags; None = the caller
    runs its generic segment sum.  Mirrors the TPU gate for cap <= 32
    and 1-D input; every CUDA call that passes it launches the kernel
    (the TPU tiling row threshold does not apply), a CPU call runs the
    plain version."""
    if cap > MAX_GROUPS or flags.dim() != 1:
        return None
    return grouped_count(flags, gid.to(torch.int64), cap)


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Every kernel of the port registers here, by wrapper name: its source
# and the TPU kernel it replaces.
KERNEL_REGISTRY = {
    "fused_agg_sums": {
        "source": "trino_tpu_torch/csrc/fused_agg.cu",
        "replaces": "trino_tpu/ops/pallas_kernels.py:188",
    },
    "grouped_count": {
        "source": "trino_tpu_torch/csrc/grouped_count.cu",
        "replaces": "trino_tpu/ops/pallas_kernels.py:128",
    },
    "grouped_sum_i64": {
        "source": "trino_tpu_torch/csrc/grouped_sum.cu",
        "replaces": "trino_tpu/ops/pallas_kernels.py:61",
    },
    "direct_probe": {
        "source": "trino_tpu_torch/csrc/direct_probe.cu",
        "replaces": "scripts/micro_probe.py:100",
    },
}
