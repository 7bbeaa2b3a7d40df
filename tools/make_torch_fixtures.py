"""Make the stored csc_tpu references of the port's CPU tests
(tests/fixtures/, tests/torch_fixtures.py says what is kept): every name
of torch_fixtures.REFERENCES, or the names given.  JAX on the CPU, about
20 minutes for all of them.

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [NAME ...]
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch_fixtures as fixtures  # noqa: E402


def main(argv):
    for name in argv or list(fixtures.REFERENCES):
        t0 = time.time()
        cases, values, full = fixtures.make(name)
        fixtures.save(name, cases, values, full)
        print(f"{name}: {fixtures.path(name)} "
              f"({os.path.getsize(fixtures.path(name))} bytes, "
              f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
