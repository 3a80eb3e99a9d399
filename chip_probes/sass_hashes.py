#!/usr/bin/env python3
"""The compiled code of every walk-kernel instantiation of one checkout:
its SASS instruction count, a hash of its instructions without addresses
(``cuobjdump -sass``, as ``launch_overhead.py`` hashes one), a second hash
with the constant-bank operands ``c[bank][offset]`` masked as well (a
field appended to the kernel's constant block moves the ``__constant__``
tables placed after it), and its registers (``ptxas -v``); then the same two hashes and the
instruction count of each kernel function in the library apart (a
library holds its variant's one-thread or repack kernel, the kernel of a
launch of several shards, and in ``walk_kernel.dealt``'s builds the dealt
loop with its plan and fold kernels). Two checkouts whose hashes agree
for an instantiation, or for a function, run the same code there. Run
both trees in one call, each by its own copy of this script:

    for t in "_archive/parent p" ". c"; do
        set -- $t; python3 $1/chip_probes/sass_hashes.py $1 $2; done

A checkout that builds variants on demand builds the ``SCRIPT_VARIANTS``
of the ``chip_smoke.py`` beside the copy that runs (this one's: the 40
the script launches, the paths' 21, phases 40-41's two freeze builds,
phase 46's general rows build and the sweep's sixteen, of which an
older checkout builds only its own 35), and a checkout with large-table
builds those of its ``LARGE_VARIANTS`` too; an older one its fixed set.
"""

import hashlib
import os
import re
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
tag = sys.argv[2]
sys.path.insert(0, tree)

from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402

assert wk.__file__.startswith(tree), wk.__file__
from this_checkout import chip_smoke  # noqa: E402

# this checkout's chip_smoke.py names the variants
variants, build_variants = (chip_smoke().SCRIPT_VARIANTS,
                            chip_smoke().build_variants)

paths, build_s, log = build_variants(wk, variants)
# and the large-table builds, in a checkout that has them
large = getattr(chip_smoke(), "LARGE_VARIANTS", ()) if hasattr(
    wk, "large_scans") else ()
if large:
    more, more_s, more_log = wk.build_library(large, large=large)
    paths.update(more)
    build_s += more_s
    log += more_log
regs = {}
for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                     r"registers", log, re.S):
    regs[m.group(1)] = int(m.group(2))
cuobjdump = os.path.join(os.path.dirname(wk._nvcc()), "cuobjdump")
names = {wk.variant_code(v): wk.kernel_name(v) for v in variants}
names.update({wk.build_code(v, True): wk.kernel_name(v) + " (large)"
              for v in large})
print(f"{tag}: {len(paths)} libraries in {build_s:.1f} s", flush=True)
for code in sorted(paths):
    sass = subprocess.run([cuobjdump, "-sass", str(paths[code])],
                          capture_output=True, text=True,
                          timeout=120).stdout
    ops = [re.sub(r"/\*[0-9a-f]+\*/|;.*$", "", line).strip()
           for line in sass.splitlines()
           if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line)]
    masked = [re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[]", op)
              for op in ops]
    print(tag, names[code], len(ops),
          hashlib.sha256("\n".join(ops).encode()).hexdigest()[:12],
          hashlib.sha256("\n".join(masked).encode()).hexdigest()[:12],
          flush=True)
    # function by function ("Function : <mangled name>" opens each)
    fn, body = None, {}
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            body[fn] = []
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            body[fn].append(re.sub(r"/\*[0-9a-f]+\*/|;.*$", "", line).strip())
    for fn in sorted(body):
        f_ops = body[fn]
        f_masked = [re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[]", op)
                    for op in f_ops]
        # the name without its anonymous namespace (which names the file)
        short = re.sub(r"^_ZN\d+_GLOBAL__N__.*?_cu_[0-9a-f]{8}\d+", "", fn)
        print(tag, " fn", names[code], short, len(f_ops),
              hashlib.sha256("\n".join(f_ops).encode()).hexdigest()[:12],
              hashlib.sha256("\n".join(f_masked).encode()).hexdigest()[:12],
              flush=True)
print(tag, "registers by entry", sorted(regs.items()), flush=True)
