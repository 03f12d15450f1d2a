#!/usr/bin/env python3
"""Count the SASS instructions, and the 32-bit integer ones among them, in
each loop of the surrogate backward kernel (csrc/hamming_bwd.cu), of the
weighted-sum backward kernel (csrc/qweighted_sum_bwd.cu) or of the
lattice's whole-row kernel (csrc/qmatvec.cu).

    python3 scripts/sass_loops.py [--root DIR] [--tag NAME]
                                  [--kernel hamming_bwd|wsum_bwd|qmatvec]

Builds (or finds) the kernel library with the port's own flags
(qmann_tpu_torch.ops.cuda._build, imported from DIR, default this
repository: an older commit unpacked into a gitignored directory is read
the same way), disassembles it with the CUDA toolkit's `cuobjdump -sass`
and takes the kernel's instance for rounding mode 3 (truncation); for the
weighted-sum backward, the FastQ instance with 128-bit accesses and two
column groups a lane (D=60), or an older commit's one FastQ instance; for
the lattice, the instance for rows of one piece (I <= 128, O <= 64: every
embedding and linear map of the configurations), or an older commit's one
FastQ instance.  A loop
is the address range from a backward branch's target to the branch.
Prints one JSON line: per loop its range, its nesting depth, its
instructions and its integer instructions (the opcodes in INT_OPS, which
issue at 64 results per clock per SM on compute capability 9.0).  Divide
an unrolled loop's counts by its rows per pass to get them per element.
Needs the CUDA toolkit (nvcc, cuobjdump); it runs on the machine with the
card.
"""
import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
INT_OPS = {"IADD3", "IADD", "IMAD", "IMUL", "LOP3", "SHF", "SHL", "SHR",
           "LEA", "ISETP", "SEL", "IMNMX", "VIMNMX", "IABS", "PRMT", "MOV",
           "BMSK", "SGXT", "PLOP3", "VIADD"}
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                   r"([A-Z0-9_]+)[.A-Z0-9_]*\s*([^;]*);")


def kernel_instrs(sass, name="hamming_bwd_kernel", instance="ILi3E"):
    """[(address, opcode, a branch's target address or None)] of the one
    function whose mangled name holds name and instance."""
    body, labels, pending, on = [], {}, [], False
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            on = name in head.group(1) and instance in head.group(1)
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if on and label:
            pending.append(label.group(1))
        hit = INSTR.search(line) if on else None
        if hit:
            addr = int(hit.group(1), 16)
            labels.update((lab, addr) for lab in pending)
            pending = []
            body.append((addr, hit.group(2), hit.group(3)))

    def target(rest):
        lab = re.search(r"\.L_x_\d+", rest)
        addr = re.search(r"0x([0-9a-f]+)", rest)
        return (labels.get(lab.group(0)) if lab
                else int(addr.group(1), 16) if addr else None)
    return [(a, op, target(rest) if op == "BRA" else None)
            for a, op, rest in body]


def loops(instrs):
    """Each backward branch's range, outermost first, with its counts."""
    spans = sorted(((t, a) for a, _, t in instrs
                    if t is not None and t <= a),
                   key=lambda s: (s[0], -s[1]))
    out = []
    for start, end in spans:
        body = [op for a, op, _ in instrs if start <= a <= end]
        out.append({"start": hex(start), "end": hex(end),
                    "depth": sum(s <= start and end <= e
                                 and (s, e) != (start, end)
                                 for s, e in spans),
                    "instructions": len(body),
                    "integer": sum(op in INT_OPS for op in body)})
    return out


# kernel: (source, function name, instance substrings in the order tried)
KERNELS = {"hamming_bwd": ("hamming_bwd.cu", "hamming_bwd_kernel",
                           ("ILi3E",)),
           "wsum_bwd": ("qweighted_sum_bwd.cu", "wsum_bwd_kernel",
                        ("5FastQILi3EEELb1EE", "5FastQILi3EEE")),
           "qmatvec": ("qmatvec.cu", "qmatvec_kernel",
                       ("5FastQILi3EEELb1E", "5FastQILi3EEE"))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--tag", default="")
    ap.add_argument("--kernel", choices=sorted(KERNELS),
                    default="hamming_bwd")
    args = ap.parse_args(argv)
    source, name, instances = KERNELS[args.kernel]
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from qmann_tpu_torch.ops.cuda import _build
    if not Path(_build.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {_build.__file__}, not the checkout at {root}")
    lib, _ = _build.build(_build.CSRC / source)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    instrs = next((found for found in (kernel_instrs(sass, name, inst)
                                       for inst in instances) if found), [])
    if not instrs:
        sys.exit(f"no mode-3 {name} in {lib}")
    print(json.dumps({"tag": args.tag or root.name, "kernel": args.kernel,
                      "library": lib.name,
                      "instructions": len(instrs),
                      "integer": sum(op in INT_OPS for _, op, _ in instrs),
                      "loops": loops(instrs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
