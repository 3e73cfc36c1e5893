"""Whether two builds of a kernel library compiled to the same SASS, entry
by entry.

    python -m cips3dpp_torch.tools.sass_diff LIB_A LIB_B [--match block_kernelILi]

Dumps both shared libraries' SASS with the CUDA toolkit's `cuobjdump
-sass` (on a host with the toolkit), strips each instruction's address
(its text and the first word of its encoding are compared; the control
word on the line after is not), and prints, for every entry function both
hold whose
mangled name contains `--match`, "identical" or how many instruction
lines differ. Used to tell a change in a kernel's code from a change in
its timing alone: e.g. a parent checkout's libdecoder_block against this
one's (both under their `_build/`).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess


def parse_sass(text: str) -> dict[str, list[str]]:
    """{entry function: its instructions} from `cuobjdump -sass` output,
    each instruction line without its address comment. An entry in an
    anonymous namespace is named without the two hashes of its source
    file's contents that its mangled name carries, so it pairs with the
    same entry of an edited source."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}", r"\1\2",
                          m.group(1))
            funcs[name] = []
        elif name is not None and "/*" in line:
            ins = re.sub(r"\s+", " ", re.sub(r"/\*[0-9a-fx]+\*/", "", line)).strip()
            if ins and not ins.startswith("/*"):
                funcs[name].append(ins)
    return funcs


def compare(a: dict, b: dict, match: str = "") -> dict[str, int]:
    """{entry in both whose name holds `match`: instruction lines that
    differ (0: identical)}."""
    return {name: sum(x != y for x, y in zip(a[name], b[name])) + abs(len(a[name]) - len(b[name]))
            for name in sorted(set(a) & set(b)) if match in name}


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--match", default="", help="only entries whose mangled name holds it")
    args = ap.parse_args(argv)
    dump = lambda lib: parse_sass(subprocess.run([_cuobjdump(), "-sass", lib],
                                                 capture_output=True, text=True,
                                                 check=True).stdout)
    a, b = dump(args.lib_a), dump(args.lib_b)
    for name, n in compare(a, b, args.match).items():
        print(f"{name}: {'identical' if n == 0 else f'{n} of {len(a[name])} lines differ'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
