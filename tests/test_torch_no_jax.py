"""csc_tpu_torch never imports jax: the card's machine has none."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
before = {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
import torch
import csc_tpu_torch, csc_tpu_torch.ops.pipeline, csc_tpu_torch.cli
import csc_tpu_torch.corpus
from csc_tpu.golden.encoder import encode_stream
from csc_tpu.props import props_init
data = b"abcabcabd " * 300
p = props_init(len(data), 1)
out = csc_tpu_torch.ops.pipeline.decode_stream(
    p, encode_stream(p, data), device=torch.device("cpu"))
assert out == data
after = {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
print(sorted(after - before))
"""


def test_import_and_decode_load_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    found = []
    for d, _, files in os.walk(os.path.join(ROOT, "csc_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    if pat.search(fh.read()):
                        found.append(f)
    assert found == []
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        assert not pat.search(fh.read())
