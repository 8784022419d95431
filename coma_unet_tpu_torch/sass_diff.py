"""Compare the SASS of two builds of the kernel library, function by function.

    python3 -m coma_unet_tpu_torch.sass_diff LIB_A LIB_B [NAME]

Disassembles both shared libraries with `cuobjdump -sass` and compares the
instructions of every function whose mangled name contains NAME (default:
every function). nvcc names each source file's anonymous namespace after
hashes that change with the build and with the source, so names are
compared with them removed; branch labels are renumbered per function in order of appearance.
Prints each function that differs or is missing on one side, then how many
are identical; exits 1 unless all are.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

# _GLOBAL__N__<hash>_<n>_<file>_cu_<hash>: both hashes go
_NAMESPACE_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_(?:(\d+_\w+?_cu_)[0-9a-f]{8})?")
_LABEL = re.compile(r"\.L_x_\d+")


def _cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    found = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found")
    return found


def functions(lib: str, name: str = "") -> dict:
    """{mangled name without the namespace hash: instruction lines} of the
    functions of `lib` whose name contains `name`."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out: dict = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            key = _NAMESPACE_HASH.sub(lambda m: "_GLOBAL__N__" + (m.group(1) or ""),
                                      line.split("Function :", 1)[1].strip())
            current = out.setdefault(key, []) if name in key else None
        elif current is not None and line.strip().startswith("/*"):
            current.append(line.strip())  # an instruction or its encoding
    for key, lines in out.items():
        labels: dict = {}
        out[key] = [_LABEL.sub(lambda m: labels.setdefault(m.group(0), f".L{len(labels)}"), s)
                    for s in lines]
    return out


def main(argv: list) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    a, b = functions(argv[0], *argv[2:]), functions(argv[1], *argv[2:])
    same = 0
    for key in sorted(set(a) | set(b)):
        if a.get(key) == b.get(key):
            same += 1
        else:
            print(f"DIFFERS {key}: {len(a.get(key, []))} / {len(b.get(key, []))} lines")
    print(f"SASS identical in {same} of {len(set(a) | set(b))} functions "
          f"({len(a)} in {argv[0]}, {len(b)} in {argv[1]})")
    return 0 if same == len(set(a) | set(b)) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
