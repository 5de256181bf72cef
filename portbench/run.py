"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``) and
a CUDA device; see ``portbench/README.md``.
"""

import sys
import time

if __name__ == "__main__":
    T0 = time.perf_counter()
    from pathlib import Path
    ROOT = Path(__file__).resolve().parent.parent
    # the checkout's root replaces this file's folder on the path, so no
    # module here shadows a standard one; the port lives under src/
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], t0=T0))
